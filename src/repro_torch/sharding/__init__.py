"""Parameter definition trees (the sharded layout comes later)."""
