"""Host-side native code of the port (g++, loaded with ctypes)."""
