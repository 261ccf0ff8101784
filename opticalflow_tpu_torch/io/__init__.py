"""Host I/O: ``.flo`` files and images (numpy only)."""
