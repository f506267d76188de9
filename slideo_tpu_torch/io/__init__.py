"""File I/O of the port: poppler page extraction and video decoding."""
