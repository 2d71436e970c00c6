"""Model configurations the port runs (``--arch`` ids in :mod:`.registry`)."""
