"""The SSD chunk computation (no kernel: see :mod:`.ops`)."""
