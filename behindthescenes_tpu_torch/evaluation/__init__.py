"""Evaluators of the port."""
