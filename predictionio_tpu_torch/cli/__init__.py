"""The port's `pio` console: ``cli.main.main``, which ``python -m
predictionio_tpu_torch`` runs.  (Nothing is re-exported here, so that
``predictionio_tpu_torch.cli.main`` stays the module.)"""
