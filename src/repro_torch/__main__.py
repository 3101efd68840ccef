"""``python -m repro_torch`` -> :func:`repro_torch.api.cli.main`."""
from repro_torch.api.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
