"""The world of ranks (``distributed``), its slice topology and process
groups (``mesh``), and the dense ring-attention reference."""
