"""``python -m deepqmc_tpu_torch [--workdir=DIR] [--device=cuda|cpu] [overrides...]``."""

from .app import cli

if __name__ == '__main__':
    cli()
