"""Launchers: batched LM serving."""
