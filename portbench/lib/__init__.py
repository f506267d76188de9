"""The harness: data files by name, traffic, the reference and the comparison."""
