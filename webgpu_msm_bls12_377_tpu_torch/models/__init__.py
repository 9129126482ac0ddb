"""The MSM engine."""
