"""Matcher models of the port."""
