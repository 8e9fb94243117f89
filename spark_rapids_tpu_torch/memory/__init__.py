"""Host memory: the global host budget and the pinned staging pool."""
