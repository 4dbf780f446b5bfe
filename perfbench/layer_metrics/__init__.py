"""One reader a per-layer metric, found by the metric's name: ``read(out,
ctx)`` takes the number from what the driver recorded (``out.readings``,
its ``trace``) and returns None where it finds nothing to read."""
