"""CLI entry point: ``python -m distkeras_tpu_torch.telemetry
report|scrape|health|top``."""

import sys

from distkeras_tpu_torch.telemetry.report import main

if __name__ == "__main__":
    sys.exit(main())
