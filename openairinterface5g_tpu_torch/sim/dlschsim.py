"""nr_dlschsim equivalent: the same codec-only chain as ulschsim (the DL
and UL SCH share TS 38.212 coding; see ulschsim.py)."""
from __future__ import annotations

import sys

from .ulschsim import main as _main


def main(argv=None):
    return _main(argv, label="DLSCH")


if __name__ == "__main__":
    sys.exit(main())
