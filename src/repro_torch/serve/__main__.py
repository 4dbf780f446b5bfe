"""``python -m repro_torch.serve``: the snapshot-serving loop's CLI
(``service.main``)."""
import sys

from repro_torch.serve.service import main

if __name__ == "__main__":
    sys.exit(main())
