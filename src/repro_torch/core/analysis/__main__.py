"""``python -m repro_torch.core.analysis`` — run the PlanCheck matrix.

The reference's module calls `main` unguarded; here the call waits for
``__main__`` so that walking the package (as the isolation check does)
imports it without running the matrix.
"""
import sys

from .driver import main

if __name__ == "__main__":
    sys.exit(main())
