"""L3 of the port: the schema-driven UPER codec (l3/per.py) that the LTE
RRC (lte/rrc.py) encodes with, copied from openairinterface5g_tpu/l3."""
