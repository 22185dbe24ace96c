"""`python -m predictionio_tpu_torch` -> the port's console, on the card."""

import sys

from .cli.main import main

sys.exit(main())
