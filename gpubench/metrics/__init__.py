"""The benchmark's metrics, one reader a file: ``read(run)`` takes what a
run saw (``gpubench.run.Run``) and returns the metric's value, or None
where it finds nothing to read."""
