"""Host tools of the port: the JSON-lines event import and export
(``import_export``, port of ``predictionio_tpu/tools/import_export.py``).
The reference's template gallery and trim tools are not ported yet."""

from .import_export import export_events, import_events, import_ratings_csv

__all__ = ["export_events", "import_events", "import_ratings_csv"]
