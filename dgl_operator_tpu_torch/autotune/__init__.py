"""The knob registry the port validates its configs against
(``knobs.py``)."""
