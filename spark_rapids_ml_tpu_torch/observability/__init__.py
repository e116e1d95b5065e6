"""Structured event records of the port."""
