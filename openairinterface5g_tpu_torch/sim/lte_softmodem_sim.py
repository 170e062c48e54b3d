"""Autotest shim: the lte-softmodem loop as a sim-style CLI
(runtime/lte_softmodem.py; pass string "LTE softmodem loop OK").

Port of openairinterface5g_tpu/sim/lte_softmodem_sim.py; takes --cycles and
--device (the card unless asked for the CPU)."""
from ..runtime.lte_softmodem import main

if __name__ == "__main__":
    import sys
    sys.exit(main())
