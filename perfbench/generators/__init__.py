"""Traffic kinds, one module each, found by the ``kind`` of a traffic file."""
