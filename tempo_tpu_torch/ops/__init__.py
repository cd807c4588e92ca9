"""The port's native host runtime, bound with ctypes (``native.py``)."""
