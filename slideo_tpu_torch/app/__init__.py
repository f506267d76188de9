"""Engine and persistence glue of the port."""
