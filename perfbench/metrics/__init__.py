"""One reader per per-layer metric, in a file named after the metric:
``read(readings)`` returns the value, or None where the run gave nothing to
read (the metric is then left out of the line)."""
