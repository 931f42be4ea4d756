"""Multi-device execution: the row-sharded frame (sharding.py)."""
