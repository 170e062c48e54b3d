"""L3 of the port: the NR control plane (RRC, NAS, NGAP, F1AP, E1AP, E2AP,
XnAP, X2AP), GTP-U and SCTP-style framing, and the schema-driven UPER codec
(l3/per.py) they and the LTE RRC (lte/rrc.py) encode with.

Host-side Python with no tensor compute: each module is a copy of its
counterpart in openairinterface5g_tpu/l3, and tests/test_torch_l3.py and
tests/test_torch_lte_stack.py hold the copies' code equal to the originals'.
"""
