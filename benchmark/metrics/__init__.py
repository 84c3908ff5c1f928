"""Metric readers, one file each, named as the metric: `read(ctx)`
returns the metric's value, or None where the run holds nothing to read
(the harness then leaves the metric out of its line)."""
