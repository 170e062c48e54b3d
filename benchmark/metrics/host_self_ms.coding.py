"""Host self time a call of the program's coding spans: rate recovery, the
decode (K1's launch), desegmentation and the CRC, summed, over the traced
stretch."""
from benchmark.spans import self_ms

CODING = ("coding/rate_recovery", "coding/decode", "coding/desegment", "coding/crc")


def read(run):
    return self_ms(CODING)
