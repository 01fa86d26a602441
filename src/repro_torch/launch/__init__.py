"""Launchers: batched LM serving and training."""
