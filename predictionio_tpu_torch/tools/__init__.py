"""Host tools of the port (ports of ``predictionio_tpu/tools``'s
``import_export``, ``trim`` and ``template_gallery``): the JSON-lines
event import and export, the event trim behind ``app trim``, and the
template gallery behind ``template list|get``."""

from .import_export import export_events, import_events, import_ratings_csv
from .trim import trim_events

__all__ = ["export_events", "import_events", "import_ratings_csv",
           "trim_events"]
