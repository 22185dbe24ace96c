"""`python -m predictionio_tpu_torch` -> the port's console, on the card."""

from .cli.main import main
from .obs.timeline import exit_process

exit_process(main())
