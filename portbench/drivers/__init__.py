"""Traffic drivers, one file a traffic kind (``<kind>.py``), named by a
traffic file's ``kind``."""
