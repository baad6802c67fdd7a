"""Host code compiled with g++ at first use (``build.py``)."""
