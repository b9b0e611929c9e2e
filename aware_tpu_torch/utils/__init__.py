"""Host utilities: WAV reading and writing (``io.py``)."""
