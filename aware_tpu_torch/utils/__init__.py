"""Host utilities: WAV reading and writing (``io.py``), the logger
(``logger.py``) and profiling hooks (``profiling.py``)."""
