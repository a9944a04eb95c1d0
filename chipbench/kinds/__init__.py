"""One runner a kind of traffic (``kind`` in its traffic file)."""
