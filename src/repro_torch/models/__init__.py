"""Model building blocks and the LM families: dense, moe, hybrid, rwkv."""
