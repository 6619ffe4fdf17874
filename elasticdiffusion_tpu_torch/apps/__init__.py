"""Condition preprocessors of the ControlNet path (canny, depth)."""
