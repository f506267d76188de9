"""The harness: data files by name, traffic, and the comparison with the plain reference."""
