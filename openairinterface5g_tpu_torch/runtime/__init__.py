"""Runtime loops of the port that drive the PHY (openairinterface5g_tpu/runtime
analogs): the lte-softmodem loop."""
