"""One reader per metric, found by the metric's name in
``BENCHMARK.json``: ``<name>.py`` defines ``read(ctx)``, which returns
the metric's value, or None where the run holds nothing to read it
from (the harness then leaves the metric out of the result line).
``_roofline.py`` holds the peaks and the work the shares count."""
