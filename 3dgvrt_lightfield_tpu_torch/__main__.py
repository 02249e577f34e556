"""Entry point: python -m 3dgvrt_lightfield_tpu_torch <subcommand> ..."""

from .app import main

if __name__ == "__main__":
    main()
