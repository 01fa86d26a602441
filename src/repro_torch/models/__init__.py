"""Model building blocks and the dense-family LM."""
