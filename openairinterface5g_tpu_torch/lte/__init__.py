"""The LTE data plane of the port: frame parameters and subframe OFDM,
reference and sync signals, code block segmentation, rate matching, and the
PDSCH and PUSCH chains (openairinterface5g_tpu/lte analogs)."""
