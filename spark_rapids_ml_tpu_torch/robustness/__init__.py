"""Failure classification and degradation records of the port."""
