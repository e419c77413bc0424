"""Model kinds, one file each (``<kind>.py``), named by a
configuration's ``model.kind``."""
