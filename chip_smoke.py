#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (an H100 for sm_90a).

    python3 chip_smoke.py

Drives the port's paths with every hand-written CUDA kernel:
  * slice 1, the PUSCH receive path (openairinterface5g_tpu_torch) at the
    100 MHz 2x2 configuration: 273 PRB, MCS 16, 2 layers, 2 RX antennas,
    8 slots per batch, 8 LDPC iterations (K3 and K1's layered f32 variant);
  * slice 2, the LDPC decoder's own entry point ``ops.ldpc_decoder.decode``
    (decode_pallas's signature) in each of its other variants (K1 flooding,
    int8 and bf16, K2), and the launch probes T1/T2 (``ops.tiny``);
  * slice 3, the launch route every kernel takes (``ops/_cuda.py``): T1/T2
    against ``torch.mul(x, 2)`` in turns, the host cost of each wrapper,
    each kernel's device-only time, and the route's raw stream handle;
  * slice 4, K1's layered kernel redesigned (``csrc/ldpc_layered.cu``):
    where its time goes at the main path's tensors;
  * slice 5, K3 redesigned (``csrc/pusch_frontend.cu``): one launch of a
    thread-block cluster per slot, the channel estimate kept on chip; its
    tile edges, B = 1, B = 40 and 16 RX held against the plain version;
  * slice 6, K1's flooding kernel (``csrc/ldpc_flooding.cu``) and K2 (now
    in ``csrc/ldpc_layered.cu``) redesigned on the layered kernel's
    compressed check-node state: every variant's iteration counts held
    against the plain version's too, and their delicate cases (Z % 32 !=
    0, one iteration, B = 1, K2 on signed zeros, int8 saturation, BG2's
    3-row layers).
  * slice 7, the link-level simulators (``openairinterface5g_tpu_torch/sim``)
    through the port's autotest: ldpctest, ulschsim and dlschsim, and five
    ulsim points of the conformance matrix (15 kHz, 273 PRB with 8 RX, 2
    layers over TDL-C, 4 layers on the unfused chain, 100 Hz Doppler),
    each with K1 and K3 where its configuration takes them.
  * slice 8, the rest of the PUSCH chain (PTRS, data on the DMRS symbols,
    double-symbol DMRS, rate-match patterns, delay-domain estimation,
    DFT-s-OFDM, the 2-layer ML receiver) and the PDSCH
    (``models/pdsch.py``, ``sim/dlsim.py``): the gNB slot at full width
    (the 273-PRB 2-layer DL slot through K3 and K1 beside the UL receiver),
    misc8's branches at the main path's width through K1 on the unfused
    chain, and the simulator cases that take them.
  * slice 9, the NR control channels (``coding/polar.py``,
    ``coding/small_block.py``, ``models/pdcch.py``, ``pbch.py``, ``sync.py``,
    ``pucch.py``, ``prach.py``) and UCI on PUSCH (``models/uci_on_pusch.py``):
    UCI on PUSCH at the main path's width through K3 and K1 (its receiver
    cuts the UCI streams from the fused frontend's codeword-order LLRs),
    each control channel at its real size, and the control simulators'
    autotest cases.
  * slice 10, the slot models (``models/srs.py``, ``prs.py``,
    ``mu_mimo.py``, ``gnb.py``, ``ue.py``) and the LTE data plane
    (``coding/turbo.py``, ``lte/``, ``sim/lte_dlsim.py``, ``lte_ulsim.py``):
    the gNB and UE slots at 273 PRB through K3 and K1, MU-MIMO through K1,
    SRS and PRS at full width, the LTE autotest cases, a 20 MHz LTE PDSCH
    and one turbo decode.
  * slice 11, the LTE control channels (``coding/viterbi.py``,
    ``lte/pbch.py``, ``pdcch.py``, ``pucch.py``, ``srs.py``, ``prach.py``),
    NB-IoT (``lte/nbiot.py``, ``sim/nbiotsim.py``) and the lte-softmodem loop
    (``lte/mac.py``, ``rrc.py``, ``l3/per.py``, ``runtime/lte_softmodem.py``):
    each control channel at 20 MHz, the nbiotsim and lte-softmodem-loop
    autotest cases.  This slice has no kernel: neither K1 nor K3 launches.
  * slice 12, the NR runtime loops (``runtime/executor.py``, ``softmodem.py``,
    ``ue_softmodem.py``, ``ra_ota.py``, ``connected_ota.py``,
    ``ru_l1_split.py``) with their L2, FAPI, radio and fronthaul copies: the
    gNB loop at 273 PRB through K3 and K1 on the executor's CUDA stream, RA
    and connected mode as two OS processes over the rfsim hub the port
    builds, the UE softmodem and the IF4p5 split, each through K3.
  * slice 13, the rest of the NR stack (``l3/``: RRC, NAS, NGAP, GTP-U,
    F1AP, E1AP, SCTP, E2AP, XnAP, X2AP; ``fronthaul/if5.py``, ``oran.py``;
    ``utils/``): the 5G SA call flow with msg3 through K3 and K1, and the
    IF5 and O-RAN 7.2 splits carrying the main path's 273-PRB slot into K3
    and K1, with ``utils/profiling.py`` timing and tracing them.
  * slice 14, multi-device (``parallel/``: ``multihost``, ``mesh``,
    ``collectives``, ``launch``, ``sharded``, ``pusch_sp``, ``dryrun``) on
    torch.distributed over NCCL: the dry run's dp, sp and dp x cb phases at
    273 PRB on every card, one rank each, through K3, K1 layered and K1
    flooding.

Phases, one line or more each:
  1. device: the card's name and power limit (nvidia-smi); no GPU -> error
  2. build every kernel from csrc/ with nvcc (one process per source)
  3. K3 (fused frontend) against its plain PyTorch version: 20 PRB at B = 8,
     then ops/pusch_frontend_cases.py's CARD_CASES (the tiles' edges at B = 3,
     the main path's configuration at B = 1 and 40, 16 and 32 RX in antenna
     groups), each case's error
  4. slice 1 main path: pusch_tx -> channel -> pusch_rx; every TB must pass
     CRC and equal the sent bits, both kernels must have launched; then
     slots/s and the host enqueue per batch (medians of 5 windows of 20
     batches, before any profiler session) and torch.mul(x, 2)'s host µs
     beside them; then the kernels held against their plain versions and
     timed at the main path's tensors (CUDA events, host enqueue per call,
     profiler kernel rows; K3's share of its bound); then K1's split there: no iteration (fill,
     one check, bits), the first iteration, a later one, the checks
     (tools/bench_ldpc_layered.py)
  5. the decoder's variants through decode() (slice 1's layered f32 with f32
     and bf16 input, and slice 2's), 4 dB, 8 iterations, BG1 Z=384 x 208
     and BG2 Z=104 x 64, check_every 0 and 1: kernel bits == plain bits ==
     sent bits, ok flags equal and all true, iteration counts equal, every
     kernel launched; then the edge cases of the flooding kernel and K2
     (DECODER_EDGES), each kernel == plain in bits, flags and iterations;
     then kernel and plain times at BG1 Z=384 x 208 for both check_every
  6. launch probes: T1/T2 against their plain version and x * 2; the raw
     stream handle against torch.cuda.current_stream() on the default
     stream, a side stream and in graph capture; T1, T2 and torch.mul(x, 2)
     in turns (tools/bench_launch.py: host µs, CUDA-event ms and graph-
     replay device ms per call, medians of 15 windows); where T1's host µs go
  7. simulators: SIM_CASES through sim/autotest.py in this process, each
     case's verdict, first SNR line, SNR of its pass, wall seconds and the
     K1 (layered f32) and K3 launches it added; each case's first
     SIM_HELD_CALLS calls of K3 and K1 held against their plain versions on
     the path's own inputs (K3 within K3_TOL, K1 bit-equal on the HARQ-
     combined LLRs); a case that does not pass, a kernel that disagrees, a
     --backend kernel case without K1 (or a reference case with it), and a
     case that K3's ``supported`` admits without K3 (or one it refuses with
     it) fail the run
  8. slice 8: (a) the gNB slot: pdsch_tx of the 273-PRB MCS-16 2-layer DL
     batch (B = 8) over the bench's channel into pdsch_rx at 2 UE antennas
     (K3 and K1), beside the UL pusch_rx of phase 4's configuration: every
     TB of both must pass CRC and equal the sent bits, K3 must launch for
     both and K1 too; then the combined slots/s (pdsch_tx + pusch_rx per
     batch, information only, host-bound), pdsch_tx's ms and its LDPC
     encode's, beside torch.mul(x, 2)'s host µs;
     (b) misc8's branches (3 DMRS symbols, cdm_groups_no_data=1, PTRS L=2
     K=2) at 273 PRB, MCS 16, 2x2, B = 8 through K1: 8/8 TBs, K1 launched,
     K3 not; its slots/s beside the main path's and its unfused frontend's
     ms per batch, whole and by stage;
     (c) SIM_CASES_8 as phase 7 runs its cases (dlsim too: K3 exactly where
     ``supported`` admits the configuration), then a 2-codeword PDSCH (6
     layers, 8 RX, 24 PRB, Pdsch2CwConfig's defaults) and a DFT-s-OFDM
     PUSCH through run_sweep with K1; every call of K3 and K1 in (a) and
     (b), and each case's first SIM_HELD_CALLS, held against the plain
     versions
  9. slice 9: (a) UCI on PUSCH at 273 PRB, MCS 16, 2x2, B = 8 through K3
     and K1 (decoder_check_every=1) over the bench's channel, twice: 6 ACK bits
     (small block, rate-matched), 16 CSI-1 bits (polar, PC bits, CRC6), 40
     CSI-2 bits (polar, CRC11); then 2 ACK bits, which puncture the data and
     CSI-2: every TB and every UCI bit recovered with its ok flag, K3 and
     K1 launched, every call of K3 held within K3_TOL of its plain version
     and of K1 bit-equal to decode_plain; ms per batch and slots/s beside
     phase 4's, and one polar SCL decode's ms (the CSI-2 stream cut from
     pusch_frontend's LLRs, B = 8);
     (b) the control channels at their real sizes, each decoded equal to
     what was sent, with ms per batch: the PDCCH blind search (ALs 4, 8, 16)
     over a 270-PRB interleaved CORESET, B = 8; SSB generate and receive
     (Lmax 8) and initial_sync with cfo_scan=1 on a 273-PRB mu=1 stream
     (FFT 4096), B = 8, the PBCH decoded again from the corrected stream;
     PUCCH F0, F1, F2 (16 PRB, 64 bits, polar) and F3 (11 bits), B = 64;
     PRACH format A2 at 273 PRB (122.88 MHz), 64 preambles, B = 32;
     (c) SIM_CASES_9 as phase 7 runs its cases: each must pass and launch
     neither K1 nor K3
 10. slice 10, B = 8, CUDA-event ms per batch of each step: (a) the gNB
     slot at 273 PRB: gnb_dl_slot with a 2-layer PDSCH on PRB 20-272, the
     SSB on PRB 0-19, the grant DCI in a 270-PRB CORESET and a 2-port
     CSI-RS, over the bench's channel into a 2-RX pdsch_rx (K3, K1); the
     MIB and the CSI-RS measured; gnb_ul_slot with the main path's PUSCH
     on symbols 0-12 (K3, K1), PUCCH F0 and F2 on symbol 13 and a PRACH
     occasion: every TB, UCI bit and preamble recovered; (b) ue_receive_slot
     on that slot with a 1-layer PDSCH: the DCI found at AL 8, the grant
     read, 8/8 TBs through K3 and not K1; (c) MU-MIMO at 273 PRB with K1
     pinned (both UEs 8/8, K3 not launched), srs_report with 2 ports over
     272 PRB (the PMI within 2 % of the channel's best gain), prs_toa at
     273 PRB, FFT 4096, osf 8 (within 0.5 samples of the delay); (d) the
     LTE autotest cases in this process, a 100-PRB MCS-28 LTE PDSCH batch
     (8/8 TBs) and one turbo decode at K = 6144, neither launching K1 nor
     K3; every K3 and K1 call of (a)-(c) held against its plain version
 11. slice 11, at 100 PRB (20 MHz) over _two_rx (2 RX, the channel known),
     CUDA-event ms per batch of each step: (a) the PBCH of 1, 2 and 4 ports
     (4 frames combined, B = 8): every MIB and its mask; one control symbol
     (B = 8) with PCFICH (CFI 1-3), PHICH (ACK, NACK) and two DCIs of
     DCI_A_11 bits (AL 2 at CCE 2, AL 8 at CCE 8, two RNTIs): every CFI and
     ACK, both DCIs through pdcch_blind_decode's default search space, none
     for a third RNTI; one viterbi.decode at L = 43; (b) PUCCH 1a and 1b of
     3 users on one PRB (covers 0/1/2) and PUCCH 2 with 4 and 13 CQI bits,
     B = 64; LTE PRACH formats 0-3, 64 preambles, a delay of 5 samples, 2
     RX, B = 32 (preambles, delays within PRACH_DELAY_TOL); SRS over 96 PRB,
     its SNR within 1 dB of the set 15 dB; (c) the nbiotsim autotest case
     in this process, its lines; (d) the lte-softmodem-loop case (4 cycles)
     in this process: its RRC and cycle lines equal LTE_LOOP_r5.txt:10-14;
     ms of the RRC connect and per cycle by the host clock, split by stage
     (each stage's calls ended by a synchronize); none of (a)-(d) launches
     K1 or K3
 12. slice 12, the NR runtime loops on the card: (a) the nr-softmodem loop
     (runtime/softmodem.py) at 273 PRB, 30 kHz: LOOP_ARGS (3 UEs x 91 PRB,
     MCS 16, 20 dB, K1 via --backend kernel, K3), LOOP_SLOTS slots FDD and
     with the TDD pattern LOOP_TDD (DDDDDDDSUU), each at executor depth 2
     and 1: every UL TB must pass; the executor's report (per-slot latency
     percentiles, deadline misses against 500 us x depth), slots/s, UL and
     DL Mb/s, the K3/K1 launches (one each per UE and UL slot); the first UL
     slot's K3 and K1 calls held against their plain versions (a run of
     its own); a DL and an UL slot under torch.cuda.set_sync_debug_mode(
     "warn"): every host sync, by the port's line that made it, in the
     loop's setup, where the executor retires a slot, or inside a slot's
     step, which fails the run (no decision is read there); (b) RA over the air
     (runtime/ra_ota.py) as two OS processes over the hub built in _build/
     (tools/ota_records.py): every [gnb] and [ue] line equal to
     RA_OTA_RECORD's, the session's wall seconds and each endpoint's K3
     launches; (c) connected mode (runtime/connected_ota.py --l2),
     CONNECTED_CYCLES cycles, two processes: every [gnb] cycle line equal
     to CONNECTED_L2_RECORD's first ones, every UL packet intact; ms per
     cycle by stage in each process (each stage's calls ended by a
     synchronize); (d) the UE softmodem (runtime/ue_softmodem.py) at its
     48 PRB, UE_LOOP_SLOTS slots: "UE softmodem OK", its [sync] and [mib]
     lines equal to the same numpy inputs' run on the CPU; (e) the IF4p5
     RU/L1 split (runtime/ru_l1_split.py) at SPLIT_TRIALS trials, RU and
     L1 in two threads on the card: the BLER gate passes
 13. slice 13, the rest of the NR stack on the card: (a) the SA call flow of
     tests/test_e2e_callflow.py with the port's modules (l3/, l2/, fapi/):
     PRACH detected, msg3 (an RRCSetupRequest in a PUSCH TB, MSG3_PUSCH, 12
     iterations) through K3 and K1 (one launch each), then RRC setup, NAS
     registration and the PDU session through NGAP, security, PDCP
     (NEA2/NIA2) over RLC UM and GTP-U on the host: the detection, the TB
     bits and every PDU equal to a CPU run of the same flow (os.urandom
     pinned for both), twice (the second run's stages timed); (b) IF5
     (fronthaul/if5.py) at FH_PUSCH (the main path's 273 PRB 2x2 MCS 16, B =
     1, 8 iterations) over the bench's channel: 60 datagrams a slot, equal to the CPU packer's, shuffled by a
     seeded generator, the waveform rebuilt within IF5_TOL of max|rx|,
     pusch_rx through K3 and K1; (c) the O-RAN 7.2 U-plane
     (fronthaul/oran.py) on the same slot's grid: 140 packets of at most
     FH_MAX_PRB PRBs (pcid = antenna), equal to the CPU packer's, the grid
     rebuilt within ORAN_TOL, pusch_rx_grid through K3 and K1; for (b) and
     (c): ms to pack, rebuild and decode, bytes and host copies a slot (one
     each way: the synchronizing operations set_sync_debug_mode("warn")
     reports from fronthaul/); (d) a profile_to
     (utils/profiling.py) capture of (b)'s receive: its Chrome trace holds
     the trace() spans and the rows of K3 and K1; the first K3 and K1 call
     of (a), (b) and (c) held against the plain versions; the stages'
     MeasGroup report
 14. slice 14, parallel/dryrun.py through launch.spawn on every card (at
     most PHASE14_MAX_WORLD), one rank each over NCCL, the kernels built by
     phase 2: on every rank (a) dp: one trial per rank at 273 PRB, MCS 16,
     2x2, two HARQ rounds over AWGN at 18 dB through pusch_rx (K3 and K1
     layered, twice each), every trial passing its CRC (the psum'd count)
     with the sent bits; (b) sp: 2 noise-free TBs at MCS 9, 2 layers,
     subcarrier-sharded over the largest n <= min(world, 7) dividing 273
     (K1 flooding once; K3 not), both TBs equal to the sent bits; (c) dp x
     cb: one trial per rank on a (2, world / 2) or (1, world) mesh, the
     frontend (K3) and an all_to_all reshard onto the code blocks (K1
     flooding), every code block passing; each phase's launches exactly
     PHASE14_LAUNCHES, its host-clock seconds; the rank's first call of K3,
     K1 layered and K1 flooding held against the plain versions; a rank
     that raises or an NCCL timeout fails the run
The line before the last is {"kernels": [...]}: every kernel with its
launches, and the error, times and bound of one configuration (slice 1's
kernels at the main path's tensors; the other decoders at BG1 Z=384 x 208,
check_every=1, f32 input, with check_every=0 under *_check_every_0 keys).
Beside ms (CUDA events over back-to-back calls), each row has device_ms
(torch.profiler's rows of the kernel's own CUDA kernels, per call) and
host_us (the wrapper's enqueue per call, median of 5 windows); K1 layered
f32 and K3 also carry launches_simulators, their launches in phase 7, and
held_simulators and max_abs_err_simulators, the calls held against plain
there and the largest error, and the same for phase 8 under launches_phase8,
held_phase8 and max_abs_err_phase8, for phase 9 under launches_phase9,
held_phase9 and max_abs_err_phase9, for phase 10 under
launches_phase10, held_phase10 and max_abs_err_phase10, and for phase 12
under launches_phase12 (summed over (a)'s timed runs and (b)-(e), the OTA
endpoints' counted in their processes), held_phase12 and
max_abs_err_phase12, and for phase 13 under launches_phase13, held_phase13
and max_abs_err_phase13; K1 layered f32, K1 flooding f32 and K3 carry
launches_phase14, held_phase14 and max_abs_err_phase14 (summed over the
ranks, the largest error of any rank).
The last line is {"ok": true,
"device": {...}}.  Any failure raises and exits non-zero.  Imports nothing
of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import pathlib
import statistics
import subprocess
import time

import numpy as np
import torch

from openairinterface5g_tpu_torch.coding import ldpc, rate_matching, turbo
from openairinterface5g_tpu_torch.coding import viterbi as lte_viterbi
from openairinterface5g_tpu_torch.config import make_frame_params
from openairinterface5g_tpu_torch.fapi.messages import RachIndication
from openairinterface5g_tpu_torch.fronthaul import if5, oran
from openairinterface5g_tpu_torch.l2.mac import MacScheduler, SchedulerConfig
from openairinterface5g_tpu_torch.l2.pdcp import DIR_DL, DIR_UL, PdcpConfig, PdcpEntity
from openairinterface5g_tpu_torch.l2.rlc import RlcUm
from openairinterface5g_tpu_torch.l2.ue_mac import UeMac
from openairinterface5g_tpu_torch.l3 import gtpu, nas, ngap, rrc
from openairinterface5g_tpu_torch.lte import params as lte_params
from openairinterface5g_tpu_torch.lte import pbch as lte_pbch
from openairinterface5g_tpu_torch.lte import pdcch as lte_pdcch
from openairinterface5g_tpu_torch.lte import pdsch as lte_pdsch
from openairinterface5g_tpu_torch.lte import prach as lte_prach
from openairinterface5g_tpu_torch.lte import pucch as lte_pucch
from openairinterface5g_tpu_torch.lte import srs as lte_srs
from openairinterface5g_tpu_torch.models import (csirs, gnb, mu_mimo, pbch, pdcch, pdsch, prach,
                                                 prs, pucch, pusch, srs, sync, uci_on_pusch, ue)
from openairinterface5g_tpu_torch.ops import _cuda, ldpc_decoder, tiny
from openairinterface5g_tpu_torch.ops import pusch_frontend as fe
from openairinterface5g_tpu_torch.ops.pusch_frontend_cases import CARD_CASES
from openairinterface5g_tpu_torch.parallel import dryrun, launch
from openairinterface5g_tpu_torch.phy import ofdm
from openairinterface5g_tpu_torch.phy.ofdm import extract_from_grid, ofdm_demodulate
from openairinterface5g_tpu_torch.runtime import (lte_softmodem, ru_l1_split, softmodem,
                                                  ue_softmodem)
from openairinterface5g_tpu_torch.sim import autotest, dlsim, prachsim, pucchsim, ulsim
from openairinterface5g_tpu_torch.sim.channel import _complex_normal, add_noise, flat_gain
from openairinterface5g_tpu_torch.tools import (bench_frontend, bench_launch, bench_ldpc_layered,
                                                ota_records)
from openairinterface5g_tpu_torch.utils import profiling

SEED = 1234
B = bench_launch.MAIN_PATH_B            # slots per batch
N_ITERS = bench_launch.MAIN_PATH_ITERS  # LDPC iterations
K3_TOL = 2e-4             # max |kernel - plain| / max |plain| of the LLR planes
N_TIMED = bench_launch.MAIN_PATH_BATCHES  # batches in a slots/s window
N_WINDOWS = 5             # windows of a host-clock or slots/s median
PROBE_WINDOWS = bench_launch.WINDOWS    # windows of the T1/T2/torch.mul turns
DECODER_SIZES = ((1, 384, 208), (2, 104, 64))   # (bg, Z, code blocks)
# the flooding kernel's and K2's delicate cases, each against the plain
# version in bits, ok flags and iteration counts: (label, bg, Z, code
# blocks, n_iters, check_every, LLR source); BG1 Z=13 and BG2 Z=104 check
# parity by the walk (Z % 32 != 0), BG2 has layers of 3 rows
DECODER_EDGES = (
    ("Z % 32 != 0, early stop every 3rd", 1, 13, 16, 8, 3, "awgn"),
    ("one iteration", 2, 104, 16, 1, 1, "awgn"),
    ("B = 1", 1, 384, 1, 8, 1, "awgn"),
    ("signed zeros", 2, 64, 12, 8, 1, "signed zeros"),
    ("saturated", 1, 104, 4, 5, 1, "saturated"),
)
# the simulator phase's cases (sim/autotest.py ids): the codec simulators,
# then conformance points at 15 kHz (25 PRB), full width (273 PRB, 8 RX),
# 2 layers over TDL-C, 4 layers on two CDM groups (the unfused chain) and
# under 100 Hz HST Doppler
SIM_CASES = ("ldpctest-BG1-8448", "ulschsim-mcs9", "dlschsim-mcs15",
             "3gpp-04-A5-8-5MHz-2rx", "3gpp-24-A5-14-100MHz-8rx", "3gpp-27-A4-27-2layer-2rx",
             "mimo-5-mcs9-4layer", "ulsim-GFR1A513-doppler100")
# slice 8's simulator cases: (sim/autotest.py id, flags added to its argv):
# misc7-misc10 (the re-map branches) and the three dlsim cases as the
# autotest lists them, misc8 and dlsim-mcs9-106 again with K1, and the
# nr_ulsim.mimo 2-layer point at MCS 10 (16QAM) with the ML receiver
SIM_CASES_8 = (("ulsim-misc7-2dmrs", ()), ("ulsim-misc8-3dmrs-ptrs", ()),
               ("ulsim-misc9-typeB-ptrs", ()), ("ulsim-misc10-typeB-8sym", ()),
               ("dlsim-mcs9-106", ()), ("dlsim-mcs27-256qam", ()), ("dlsim-csirs-ratematch", ()),
               ("ulsim-misc8-3dmrs-ptrs", ("--backend", "kernel")),
               ("dlsim-mcs9-106", ("--backend", "kernel")),
               ("mimo-3-mcs10-2layer", ("--receiver", "ml")))
# misc8's branches at the main path's width (phase 8 b)
MISC8_WIDE = dict(mu=1, n_prb=273, mcs=16, n_layers=2, n_rx=2, dmrs_symbols=(2, 7, 11),
                  cdm_groups_no_data=1, ptrs=True, ptrs_l=2, ptrs_k=2,
                  decoder_backend="kernel", decoder_check_every=1)
# slice 9: UCI on PUSCH at the main path's width (phase 9 a), rate-matched
# ACK with both CSI parts, then an ACK that punctures
UCI_WIDE_PUSCH = dict(mu=1, n_prb=273, mcs=16, n_layers=2, n_rx=2, decoder_backend="kernel",
                      decoder_check_every=1)
UCI_WIDE = (dict(n_ack_bits=6, n_csi1_bits=16, n_csi2_bits=40),
            dict(n_ack_bits=2, n_csi1_bits=16, n_csi2_bits=40))
N_TIMED_9 = 4             # batches in a phase-9 window (host-bound: eager SCL)
B_PUCCH, B_PRACH = 64, 32
# the control simulators' autotest cases (phase 9 c)
SIM_CASES_9 = tuple((cid, ()) for cid in (
    "polartest-DCI", "polartest-UCI", "pbchsim-m7dB", "pucchsim-f0-2bit",
    "pucchsim-f2-64bit-16prb", "pucchsim-f3-11bit", "prachsim-3-A2-273",
    "prachsim-9-fmt0-restricted"))
# calls of K3 and of K1 held against their plain versions in each case: the
# first batch's two HARQ rounds (rv 0, then rv 2 combined into rv 0's
# buffer), or two batches where a case runs one round
SIM_HELD_CALLS = 2

# Roofline of one H100 SXM (NVIDIA data sheet, at 700 W): HBM bytes/s and
# f32 operations/s outside the tensor cores, which counts an FMA as two.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# The decoders' operations (compare, select, add, xor on 32-bit lanes: bf16
# is computed in f32, int8 messages in int32) are one instruction each and
# fuse into no FMA, so they issue at most once per lane and clock:
# 132 SMs x 128 lanes x 1.98 GHz = 33.5e12 per second.
MIN_SUM_OPS_PER_S = 33.5e12
# operations per edge, lane and iteration of min-sum: v = t - o, |v|, three
# for min1/min2, sign xor, the excluded-min compare and select, the sign
# select, and the two operations of the total update (flooding: one add in
# the variable-node pass and no update); per row, lane and iteration: the
# scale of m1 and of m2; per edge and lane of a syndrome check: load
# compare and xor
OPS_PER_EDGE_ITER = 11
OPS_PER_ROW_ITER = 2
OPS_PER_EDGE_CHECK = 2

# (label, kernel name, schedule, message type, input type); the first row of
# a kernel (f32 input) is the one the kernels line reports
VARIANTS = (
    ("layered f32", "layered_f32", "layered", torch.float32, torch.float32),
    ("layered f32, bf16 input", "layered_f32", "layered", torch.float32, torch.bfloat16),
    ("flooding f32", "flooding_f32", "flooding", torch.float32, torch.float32),
    ("flooding f32, bf16 input", "flooding_f32", "flooding", torch.float32, torch.bfloat16),
    ("int8 layered", "layered_int8", "layered", torch.int8, torch.float32),
    ("int8 flooding", "flooding_int8", "flooding", torch.int8, torch.float32),
    ("bf16 flooding", "flooding_bf16", "flooding", torch.bfloat16, torch.float32),
    ("K2 bf16 layered", "layered_bf16", "layered", torch.bfloat16, torch.float32),
)
K1_LAYERED = "openairinterface5g_tpu_torch/csrc/ldpc_layered.cu"   # and K2
K1_FLOODING = "openairinterface5g_tpu_torch/csrc/ldpc_flooding.cu"
K1_TPU = "openairinterface5g_tpu/ops/ldpc_pallas.py:61"
KERNEL_SOURCES = {
    "layered_f32": (K1_LAYERED, K1_TPU), "flooding_f32": (K1_FLOODING, K1_TPU),
    "layered_int8": (K1_LAYERED, K1_TPU), "flooding_int8": (K1_FLOODING, K1_TPU),
    "flooding_bf16": (K1_FLOODING, K1_TPU),
    "layered_bf16": (K1_LAYERED, "openairinterface5g_tpu/ops/ldpc_pallas.py:383"),
    "pusch_frontend": ("openairinterface5g_tpu_torch/csrc/pusch_frontend.cu",
                       "openairinterface5g_tpu/ops/pusch_frontend_pallas.py:162"),
    "tiny": ("openairinterface5g_tpu_torch/csrc/tiny.cu", "tools/bench_overhead.py:53"),
    "tiny_grid": ("openairinterface5g_tpu_torch/csrc/tiny.cu", "tools/bench_overhead.py:81"),
}
# names of each kernel's own CUDA kernels, as torch.profiler's rows show them
DEVICE_KERNELS = {
    "layered_f32": ("ldpc_layered_kernel",), "layered_int8": ("ldpc_layered_kernel",),
    "flooding_f32": ("ldpc_flooding_kernel",), "flooding_int8": ("ldpc_flooding_kernel",),
    "flooding_bf16": ("ldpc_flooding_kernel",),
    "layered_bf16": ("ldpc_layered_kernel",),
    "pusch_frontend": ("frontend_kernel",),
    "tiny": ("times_two_kernel",), "tiny_grid": ("times_two_kernel",),
}


_time_ms = bench_launch.events_ms


def _host_us(fn, calls: int) -> float:
    """Host µs per call of fn, enqueue only: median of N_WINDOWS windows of
    `calls` back-to-back calls."""
    return statistics.median(bench_launch.host_us(fn, calls) for _ in range(N_WINDOWS))


def _device_ms(name: str, fn, calls: int) -> float:
    """Device ms per call of fn: the profiler rows of kernel `name`'s own
    CUDA kernels (tools/bench_ldpc_layered.py::device_ms)."""
    return bench_ldpc_layered.device_ms(fn, calls, DEVICE_KERNELS[name])


def _bound(n_bytes: float, n_ops: float,
           ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    """(least ms the card could take, what bounds it)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _decoder_bound(g, x: torch.Tensor, iters: torch.Tensor,
                   check_every: int) -> tuple[float, str]:
    """K1/K2's bound for one decode of `x`: the input read once, bits and
    flags written once, and the operations of the iterations and checks
    each code block actually ran (`iters`, from the plain version's early
    stop), with one more check for the ok flag only where the last
    iteration ran none (a check of the final totals gives the flag)."""
    E = int(g.evalid.sum())
    n_bytes = x.numel() * x.element_size() + x.shape[0] * (g.K + 1)
    it = float(iters.sum())
    if check_every:
        n_checks = float((iters // check_every).sum() + (iters % check_every != 0).sum())
    else:
        n_checks = float(x.shape[0])
    n_ops = g.Z * (it * (OPS_PER_EDGE_ITER * E + OPS_PER_ROW_ITER * g.rows)
                   + OPS_PER_EDGE_CHECK * E * n_checks)
    return _bound(n_bytes, n_ops, MIN_SUM_OPS_PER_S)


def _k3_ops(cfg) -> int:
    """Arithmetic operations of one K3 call (B slots): the work of the
    function (estimate per antenna and pilot, then per data RE), the same
    for any kernel that computes it, so a parent and a change share one
    bound.  A complex multiply is 6, a complex add 2, |z|^2 3, a divide,
    select or fabs 1; index arithmetic is not counted."""
    P, R, qm = cfg.n_layers, cfg.n_rx, cfg.qm_rate[0]
    n_dmrs, n_data, w = len(cfg.dmrs_symbols), len(cfg.data_symbols), cfg.chest_window
    n_pil, M = 6 * cfg.n_prb, 12 * cfg.n_prb
    # the estimate, per antenna and pilot: LS and its sum per DMRS symbol
    # (8; 1 layer: the adjacent-pilot noise term, 12 more) and the mean (2);
    # 2 layers: the OCC split (8) and the pair-difference noise term on
    # every second pilot (20); per port the replicate-padded window sum
    # and mean (2w + 2); per port and subcarrier, the off-comb half
    # interpolated (4 each, 2 on average)
    per_pilot = n_dmrs * (8 + (12 if P == 1 else 0)) + 2 + (18 if P == 2 else 0)
    per_pilot += P * (2 * w + 2) if w > 1 else 0
    est = R * (n_pil * per_pilot + P * M * 2)
    # equalization, per data RE: per antenna the matched filter and
    # gain of each layer (12), 2 layers the cross term (8) too; the closed-
    # form 2x2 MMSE (38); per layer the qm max-log LLRs and their
    # descrambling selects
    llr = {2: 2, 4: 5, 6: 10, 8: 15}[qm]
    per_re = R * (12 if P == 1 else 32) + (38 if P == 2 else 0) + P * (llr + qm)
    return B * (est + n_data * M * per_re)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on a GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    line = smi.stdout.strip().splitlines()[0]
    print(line)
    return line


def phase_build() -> None:
    t0 = time.perf_counter()
    so = _cuda.build()
    _cuda.route()
    print(f"build: {so.name} from {len(_cuda.sources())} sources in "
          f"{time.perf_counter() - t0:.1f} s")


def _k3_err(tag: str, got: torch.Tensor, ref: torch.Tensor) -> tuple[float, str]:
    """K3 output against its plain version: returns max |kernel - plain|
    and a line that states it; raises on a shape, a non-finite value or a
    relative error >= K3_TOL."""
    if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"K3 {tag}: shape {tuple(got.shape)} or non-finite")
    abs_err = float((got - ref).abs().max())
    err = abs_err / float(ref.abs().max())
    if not err < K3_TOL:
        raise AssertionError(f"K3 {tag}: relative error {err:.3e} >= {K3_TOL}")
    return abs_err, (f"K3 pusch_frontend {tag}: max err / max|LLR| = {err:.3e} "
                     f"(max abs err {abs_err:.3e})")


def _k3_check(tag: str, got: torch.Tensor, ref: torch.Tensor) -> float:
    """_k3_err, printing its line."""
    abs_err, line = _k3_err(tag, got, ref)
    print(line)
    return abs_err


def phase_frontend(dev, gen) -> None:
    cases = [(dict(n_prb=20, mcs=16, n_layers=2, n_rx=2), B), *CARD_CASES]
    for kw, slots in cases:
        cfg = pusch.PuschConfig(mu=1, **kw)
        y = bench_frontend.grid(cfg, dev, gen, slots)
        tag = " ".join(f"{k}={v}" for k, v in kw.items())
        _k3_check(f"{tag} B={slots}", fe.frontend_planes(cfg, y),
                  fe.frontend_planes_plain(cfg, y))


def phase_main_path(dev, gen, card: str) -> dict:
    rcv = bench_launch.receiver(dev, gen)
    cfg, tb, rx, re_grid, g, planes, llr = (rcv.cfg, rcv.tb, rcv.rx, rcv.re_grid, rcv.graph,
                                             rcv.planes, rcv.llr)

    _reset_counts()
    out = pusch.pusch_rx(cfg, rx, n_iters=N_ITERS)
    torch.cuda.synchronize()
    launches = _counts()
    if min(launches.values()) < 1:
        raise AssertionError(f"main path missed a kernel: launches {launches}")
    n_ok = int(out["tb_ok"].sum())
    if n_ok != B or not torch.equal(out["tb_bits"], tb):
        raise AssertionError(f"main path: {n_ok}/{B} TBs pass CRC, bits equal: "
                             f"{torch.equal(out['tb_bits'], tb)}")
    p, _ = cfg.seg_params()
    print(f"main path: 273 PRB MCS16 2x2 B={B}: {n_ok}/{B} TBs pass CRC and equal the "
          f"sent bits ({B * p.C} code blocks); launches {launches}")

    # slots/s and host costs before any profiler session of this process
    host = bench_launch.receiver_host(rcv, N_WINDOWS)
    med = {k: statistics.median(v) for k, v in host.items()}
    ms, batch_ms, enqueue_us = med["batch_ms"], host["batch_ms"], host["enqueue_us"]
    print(f"main path: {B * 1000.0 / ms:.1f} slots/s ({ms:.4f} ms per {B}-slot batch, CUDA "
          f"events, median of {N_WINDOWS} windows of {N_TIMED} batches, range "
          f"{min(batch_ms):.4f}-{max(batch_ms):.4f}); host enqueue {med['enqueue_us'] / 1e3:.4f} "
          f"ms per batch (range {min(enqueue_us) / 1e3:.4f}-{max(enqueue_us) / 1e3:.4f}) on {card}")
    calls = bench_launch.in_torch_mul_calls(host)
    print(f"main path host us, medians of {N_WINDOWS} windows: torch.mul(x, 2) on (8, 128) "
          f"{med['torch_mul_us']:.3f}; in torch.mul calls of the same window: batch enqueue "
          f"{calls['enqueue_us']:.2f}, K3 wrapper {calls['pusch_frontend_us']:.3f}, K1 wrapper "
          f"{calls['layered_f32_us']:.3f}")

    # both kernels against their plain versions, then timed, at the main
    # path's own tensors
    errs = {"pusch_frontend": _k3_check(f"main path {cfg.n_prb} PRB B={B}", planes,
                                        fe.frontend_planes_plain(cfg, re_grid))}
    bk, okk = ldpc_decoder.decode(g, llr, N_ITERS, check_every=1)
    bp, okp, iters = ldpc_decoder.decode_plain(g, llr, N_ITERS, check_every=1,
                                               return_iters=True)
    if not (torch.equal(bk, bp) and torch.equal(okk, okp)):
        raise AssertionError("main path K1: kernel bits or ok flags differ from plain")
    errs["layered_f32"] = int((bk.int() - bp.int()).abs().max())
    print(f"K1 layered f32 at the main path's {B * p.C} code blocks (bf16 LLRs, "
          f"check_every=1): kernel == plain, {int(okk.sum())}/{okk.numel()} parity ok")

    def k3():
        return fe.frontend_planes(cfg, re_grid)

    def k1():
        return ldpc_decoder.decode(g, llr, N_ITERS, check_every=1)

    times = {
        "pusch_frontend": (_time_ms(k3, 20),
                           _time_ms(lambda: fe.frontend_planes_plain(cfg, re_grid), 5)),
        "layered_f32": (_time_ms(k1, 20),
                        _time_ms(lambda: ldpc_decoder.decode_plain(g, llr, N_ITERS, check_every=1), 3)),
    }
    host = {"pusch_frontend": med["pusch_frontend_us"], "layered_f32": med["layered_f32_us"]}
    device = {"pusch_frontend": _device_ms("pusch_frontend", k3, 20),
              "layered_f32": _device_ms("layered_f32", k1, 5)}
    bounds = {
        "layered_f32": _decoder_bound(g, llr, iters, 1),
        "pusch_frontend": _bound(
            re_grid.numel() * re_grid.element_size() + planes.numel() * planes.element_size(),
            _k3_ops(cfg)),
    }
    k3_bound = bounds["pusch_frontend"][0]
    print(f"K3 at the main path's tensors: {device['pusch_frontend']:.4f} ms on the device "
          f"(profiler), bound {k3_bound:.4f} ms ({bounds['pusch_frontend'][1]}): "
          f"{100 * k3_bound / device['pusch_frontend']:.1f} % of the bound")
    print(f"main path decode: {B * p.C} code blocks ran {float(iters.float().mean()):.3f} "
          f"iterations each on average (plain version's early stop, check_every=1)")
    for name in times:
        print(f"{name} at the main path's tensors: {times[name][0]:.4f} ms by CUDA events, "
              f"{device[name]:.4f} ms on the device (profiler), wrapper enqueue "
              f"{host[name]:.2f} us per call")
    split = bench_ldpc_layered.split(g, llr)
    print(f"K1 split at the main path's tensors, device ms (profiler rows): no iteration "
          f"(fill, one check, bits) {split['no_iteration']:.4f}, first iteration "
          f"{split['first_iteration']:.4f}, one later iteration {split['iteration']:.4f}, "
          f"checks beyond the final one {split['checks']:.4f} ("
          + ", ".join(f"{k}: {v:.4f}" for k, v in split["times"].items()) + ")")
    return {"launches": launches, "errs": errs, "times": times, "bounds": bounds,
            "device": device, "host": host, "split": split, "slots_per_s": B * 1000.0 / ms}


def phase_decoder(dev, gen) -> dict:
    """The decoder's entry point decode() in every variant, at both sizes
    and check_every 0 and 1, against its plain version and the sent bits;
    launch counts; then times at BG1 Z=384 x 208."""
    for k in ldpc_decoder.launches:
        ldpc_decoder.launches[k] = 0
    cases = [bench_ldpc_layered.awgn_code_blocks(bg, Z, n_cb, dev, gen)
             for bg, Z, n_cb in DECODER_SIZES]
    errs, iters = {}, {}                # (label, check_every) -> at BG1 Z=384 x 208
    for i, (g, info, llr) in enumerate(cases):
        for label, name, schedule, msg_dtype, in_dtype in VARIANTS:
            x = llr.to(in_dtype).contiguous()
            for ce in (0, 1):
                kw = dict(schedule=schedule, msg_dtype=msg_dtype, check_every=ce,
                          return_iters=True)
                bk, okk, ik = ldpc_decoder.decode(g, x, N_ITERS, **kw)
                torch.cuda.synchronize()
                bp, okp, it = ldpc_decoder.decode_plain(g, x, N_ITERS, **kw)
                tag = f"{label} BG{g.bg} Z={g.Z} x{x.shape[0]} check_every={ce}"
                if not torch.equal(bk, bp):
                    raise AssertionError(f"{tag}: kernel bits differ from plain in "
                                         f"{int((bk != bp).sum())} places")
                if not torch.equal(ik, it):
                    raise AssertionError(f"{tag}: iteration counts differ from plain in "
                                         f"{int((ik != it).sum())} code blocks")
                if not torch.equal(bk, info):
                    raise AssertionError(f"{tag}: bits differ from sent")
                if not (torch.equal(okk, okp) and bool(okk.all())):
                    raise AssertionError(f"{tag}: ok flags differ or fail "
                                         f"({int(okk.sum())}/{okk.numel()} kernel)")
                if i == 0:
                    errs[label, ce] = int((bk.int() - bp.int()).abs().max())
                    iters[label, ce] = it
        print(f"BG{g.bg} Z={g.Z} x{llr.shape[0]}: every variant at check_every 0 and 1: "
              f"kernel == plain == sent, iteration counts equal, all parity ok")
    launches = {name: ldpc_decoder.launches[name] for name in ldpc_decoder.launches}
    if min(launches.values()) < 1:
        raise AssertionError(f"decoder path missed a kernel: launches {launches}")
    print(f"decoder variants: launches {launches}")
    _decoder_edges(dev, gen)

    g, _, llr = cases[0]
    rows = {}
    for label, name, schedule, msg_dtype, in_dtype in VARIANTS:
        x = llr.to(in_dtype).contiguous()
        row = {}
        for ce in (0, 1):
            kw = dict(schedule=schedule, msg_dtype=msg_dtype, check_every=ce)

            def kernel():
                return ldpc_decoder.decode(g, x, N_ITERS, **kw)

            ms = _time_ms(kernel, 10)
            plain_ms = _time_ms(lambda: ldpc_decoder.decode_plain(g, x, N_ITERS, **kw), 2)
            it = iters[label, ce]
            bound, by = _decoder_bound(g, ldpc_decoder.prepare_input(x, msg_dtype), it,
                                       0 if name == "layered_bf16" else ce)   # K2: no checks
            row[ce] = {"ms": ms, "plain_ms": plain_ms, "bound": (bound, by),
                       "err": errs[label, ce], "mean_iters": float(it.float().mean()),
                       "device_ms": _device_ms(name, kernel, 5), "host_us": _host_us(kernel, 20)}
            print(f"{label} BG{g.bg} Z={g.Z} x{x.shape[0]} check_every={ce}: kernel {ms:.4f} ms, "
                  f"device {row[ce]['device_ms']:.4f} ms, enqueue {row[ce]['host_us']:.2f} us, "
                  f"plain {plain_ms:.4f} ms, bound {bound:.5f} ms ({by}), "
                  f"{row[ce]['mean_iters']:.3f} iterations per code block")
        rows.setdefault(name, row)           # first row of a kernel: f32 input
    return {"launches": launches, "rows": rows}


def _edge_llr(g, n_cb: int, source: str, dev, gen) -> torch.Tensor:
    """LLRs of one DECODER_EDGES case: AWGN at 2 dB; "signed zeros": only
    +0.0 and -0.0 (K2 takes the sign bit as the sign); "saturated": AWGN at
    12 dB times 50, so int8 messages saturate at +-127."""
    if source == "signed zeros":
        neg = torch.rand((n_cb, g.cols * g.Z), generator=gen, device=dev) < 0.5
        zero = torch.zeros((n_cb, g.cols * g.Z), device=dev)
        return torch.where(neg, -zero, zero)
    snr = 12.0 if source == "saturated" else 2.0
    llr = bench_ldpc_layered.awgn_code_blocks(g.bg, g.Z, n_cb, dev, gen, snr_db=snr)[2]
    return llr * 50 if source == "saturated" else llr


def _decoder_edges(dev, gen) -> None:
    """The flooding kernel's and K2's delicate cases (DECODER_EDGES): each
    redesigned variant == plain in bits, ok flags and iteration counts."""
    redesigned = [v for v in VARIANTS if v[1] not in ("layered_f32", "layered_int8")]
    for tag, bg, Z, n_cb, n_iters, ce, source in DECODER_EDGES:
        g = ldpc.build_graph(bg, Z)
        llr = _edge_llr(g, n_cb, source, dev, gen)
        for label, name, schedule, msg_dtype, in_dtype in redesigned:
            kw = dict(schedule=schedule, msg_dtype=msg_dtype, check_every=ce,
                      return_iters=True)
            x = llr.to(in_dtype).contiguous()
            got = ldpc_decoder.decode(g, x, n_iters, **kw)
            want = ldpc_decoder.decode_plain(g, x, n_iters, **kw)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"decoder edge case {tag}, {label}: kernel bits, flags or "
                                     f"iterations differ from plain")
    print(f"decoder edge cases ({', '.join(e[0] for e in DECODER_EDGES)}): flooding f32, "
          f"f32 with bf16 input, int8, bf16 and K2 == plain in bits, flags and iterations")


def _check_raw_stream(dev) -> None:
    """The route's raw stream handle is torch.cuda.current_stream()'s on
    the default stream, on a side stream and during graph capture."""
    r = _cuda.route()

    def same(where: str) -> None:
        raw, cur = r.stream(dev.index), torch.cuda.current_stream(dev).cuda_stream
        if raw != cur:
            raise AssertionError(f"raw stream {raw:#x} != current stream {cur:#x} {where}")

    same("on the default stream")
    with torch.cuda.stream(torch.cuda.Stream(dev)):
        same("on a side stream")
    x = torch.zeros((8, 128), device=dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        same("during graph capture")
        x.mul_(2)
    print("route: raw stream handle == torch.cuda.current_stream().cuda_stream on the "
          "default stream, on a side stream and during graph capture")


def _t1_route_parts(x: torch.Tensor) -> dict:
    """Host µs per call of each step of T1's launch path, medians of
    PROBE_WINDOWS windows in turns beside the whole wrapper and
    torch.mul(x, 2):
    the check, the output allocation, the raw stream, and the ctypes call
    alone (n_blocks = 0: the entry point returns before its device guard
    and launch); the rest of the wrapper is the launch and the Python
    between the steps."""
    r = _cuda.route()
    out = torch.empty_like(x)
    xp, op, index = x.data_ptr(), out.data_ptr(), x.get_device()
    s = r.stream(index)
    parts = {
        "torch.mul": lambda: torch.mul(x, 2),
        "wrapper": lambda: tiny.tiny(x),
        "check": lambda: tiny.check_args("tiny", x.shape, x.dtype, x.is_contiguous()),
        "empty_like": lambda: torch.empty_like(x),
        "stream": lambda: r.stream(index),
        "ctypes call, no launch": lambda: r.tiny_times_two(xp, op, 0, index, s),
    }
    names = list(parts)
    samples = {k: [] for k in names}
    for w in range(PROBE_WINDOWS):
        for k in (names if w % 2 == 0 else names[::-1]):
            samples[k].append(bench_launch.host_us(parts[k]))
    us = {k: statistics.median(v) for k, v in samples.items()}
    us["launch and the rest"] = us["wrapper"] - sum(us[k] for k in names[2:])
    return us


def phase_probes(dev, gen) -> dict:
    """Launch probes T1/T2 against their plain version and x * 2; then the
    route: its raw stream, T1/T2 against torch.mul(x, 2) in turns, and
    where T1's host µs go."""
    for k in tiny.launches:
        tiny.launches[k] = 0
    out = {}
    for name, fn, shape in (("tiny", tiny.tiny, (8, 128)),
                            ("tiny_grid", tiny.tiny_grid, (8, 8, 128))):
        x = torch.randn(shape, generator=gen, device=dev)
        got = fn(x)
        torch.cuda.synchronize()
        err = float((got - tiny.tiny_plain(x)).abs().max())
        if err != 0.0:
            raise AssertionError(f"{name}: kernel differs from x * 2 by {err}")
        out[name] = {"err": err, "x": x, "fn": fn}
    launches = dict(tiny.launches)
    if min(launches.values()) < 1:
        raise AssertionError(f"launch probes missed a kernel: launches {launches}")

    _check_raw_stream(dev)
    samples = bench_launch.turns(bench_launch.probes(dev, gen), PROBE_WINDOWS)
    turns, ratios = bench_launch.summary(samples), bench_launch.ratios(samples)
    for name, r in out.items():
        x, fn = r["x"], r["fn"]
        mine, lib = turns[name], turns[bench_launch.PAIRS[name]]
        r["ms"], r["library_ms"] = mine["ms"]["median"], lib["ms"]["median"]
        r["host_us"], r["library_host_us"] = mine["host_us"]["median"], lib["host_us"]["median"]
        r["graph_device_ms"] = mine["device_ms"]["median"]
        r["library_device_ms"] = lib["device_ms"]["median"]
        r["ratio_to_library"] = ratios[name]
        r["plain_ms"] = _time_ms(lambda: tiny.tiny_plain(x), 200)
        r["device_ms"] = _device_ms(name, lambda: fn(x), 200)
        r["bound"] = _bound(2 * x.numel() * 4, x.numel())
        print(f"{name} {tuple(x.shape)}: kernel == x * 2; per call, medians of {PROBE_WINDOWS} "
              f"windows in turns, kernel / torch.mul(x, 2): host {r['host_us']:.3f} / "
              f"{r['library_host_us']:.3f} us, CUDA events {r['ms']:.5f} / "
              f"{r['library_ms']:.5f} ms, graph replay {r['graph_device_ms']:.5f} / "
              f"{r['library_device_ms']:.5f} ms; profiler {r['device_ms']:.5f} ms; plain "
              f"{r['plain_ms']:.5f} ms; median ratio to torch.mul within a window: host "
              f"{ratios[name]['host_us']:.3f}, events {ratios[name]['ms']:.3f}, graph replay "
              f"{ratios[name]['device_ms']:.3f}")
    print(f"launch turns: {json.dumps(turns)}")
    parts = _t1_route_parts(out["tiny"]["x"])
    print("T1 route, host us per call: " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()))
    return {"launches": launches, "probes": out, "route_parts": parts}


@contextlib.contextmanager
def _held_to_plain(cid: str, held: dict, lines: list, limit: int = SIM_HELD_CALLS,
                   kernels: tuple = ("pusch_frontend", "layered_f32")):
    """While a simulator case runs, its first `limit` calls of K3
    (``fe.frontend_planes``) and of each K1 variant of `kernels`
    (``ldpc_decoder.decode``) are held against the plain versions on the
    same inputs: the path's own grids, and its rate-recovered, HARQ-combined
    LLRs at the case's iteration count.  The plain versions run in PyTorch,
    so the check adds no launch.  K3 within K3_TOL of max|plain|, K1
    bit-equal in bits and ok flags; `held` collects per kernel the calls
    held and the largest error, `lines` a line per call held (the case's
    own output is captured)."""
    k3, k1 = fe.frontend_planes, ldpc_decoder.decode
    n = dict.fromkeys(kernels, 0)

    def k3_held(cfg, re_grid):
        planes = k3(cfg, re_grid)
        if n.get("pusch_frontend", limit) < limit:
            n["pusch_frontend"] += 1
            tag = (f"{cid} call {n['pusch_frontend']}: mu={cfg.mu} {cfg.n_prb} PRB "
                   f"{cfg.n_layers}x{cfg.n_rx} Qm={cfg.qm_rate[0]} window {cfg.chest_window} "
                   f"B={re_grid.shape[0]}")
            err, line = _k3_err(tag, planes, fe.frontend_planes_plain(cfg, re_grid))
            lines.append(line)
            _note(held, "pusch_frontend", err)
        return planes

    def k1_held(g, llr, n_iters=8, **kw):
        got = k1(g, llr, n_iters, **kw)
        name = ldpc_decoder.kernel_name(kw.get("schedule", "layered"),
                                        kw.get("msg_dtype", torch.float32))
        if name in n and n[name] < limit:
            n[name] += 1
            want = ldpc_decoder.decode_plain(g, llr, n_iters, **kw)
            tag = (f"K1 {name} {cid} call {n[name]}: BG{g.bg} Z={g.Z} x{llr.shape[0]} "
                   f"{str(llr.dtype).removeprefix('torch.')} input, {n_iters} iterations")
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"{tag}: kernel bits or ok flags differ from plain in "
                                     f"{int((got[0] != want[0]).sum())} bits, "
                                     f"{int((got[1] != want[1]).sum())} flags")
            lines.append(f"{tag}: kernel == plain in bits and ok flags "
                         f"({int(want[1].sum())}/{want[1].numel()} parity ok)")
            _note(held, name, int((got[0].int() - want[0].int()).abs().max()))
        return got

    fe.frontend_planes, ldpc_decoder.decode = k3_held, k1_held
    try:
        yield
    finally:
        fe.frontend_planes, ldpc_decoder.decode = k3, k1


def _note(held: dict, name: str, err: float) -> None:
    calls, worst = held.get(name, (0, 0.0))
    held[name] = (calls + 1, max(worst, err))


def _reset_counts() -> None:
    fe.launches = 0
    for k in ldpc_decoder.launches:
        ldpc_decoder.launches[k] = 0


def _counts() -> dict:
    return {"layered_f32": ldpc_decoder.launches["layered_f32"], "pusch_frontend": fe.launches}


def _check_kernels(tag: str, k1: int, k3: int, want_k1: bool, want_k3: bool) -> None:
    got = {"K1": k1 > 0, "K3": k3 > 0}
    if got != {"K1": want_k1, "K3": want_k3}:
        raise AssertionError(f"{tag}: kernels launched {got}, its configuration takes "
                             f"{{'K1': {want_k1}, 'K3': {want_k3}}}")


def _sim_cases(cases, held: dict, show_output: bool = False) -> dict:
    """Each (autotest id, added flags) of `cases` through the port's autotest
    in this process, on the card: its verdict, its K1 (layered f32) and K3
    launches against what its configuration takes, its first K1 and K3
    calls held against their plain versions.  show_output prints each
    case's own lines too.  Returns each case's autotest result."""
    table = {c[0]: c[1:4] for c in autotest.CASES}
    table.update({cid: ("ulsim", argv, "PUSCH test OK")
                  for cid, argv in autotest.CONFORMANCE_CASES})
    results = {}
    for cid, extra in cases:
        module, argv, pass_str = table[cid]
        argv = [*argv, *extra]
        name = " ".join([cid, *extra])
        k1_0, k3_0 = ldpc_decoder.launches["layered_f32"], fe.launches
        lines = []
        with _held_to_plain(name, held, lines):
            r = autotest.judge(cid, module, argv, pass_str, device="cuda")
        k1, k3 = ldpc_decoder.launches["layered_f32"] - k1_0, fe.launches - k3_0
        where = r.status if r.status != "PASS" else \
            "passed" if r.last_snr_db is None else f"passed at {r.last_snr_db:.2f} dB"
        first = f"; first: {r.first_snr_line}" if r.first_snr_line else ""
        print(f"simulator {name}: {where} in {r.seconds:.1f} s{first}; launches K1 {k1}, K3 {k3}")
        for line in lines + (r.output.splitlines() if show_output else []):
            print(f"  {line}")
        if r.status != "PASS":
            raise AssertionError(f"simulator {name}: {r.status}\n{r.output}")
        if module == "ulsim":
            cfg = ulsim.config(ulsim.parse_args(argv))
        elif module == "dlsim":
            cfg = dlsim.config(dlsim.parse_args(argv))[0]
        else:                                   # codec simulators: the flooding decoder
            cfg = None
        _check_kernels(f"simulator {name}", k1, k3,
                       cfg is not None and cfg.decoder_backend == "kernel",
                       cfg is not None and fe.supported(cfg))
        results[name] = r
    return results


def phase_simulators() -> dict:
    """SIM_CASES through the port's autotest in this process, on the card,
    each case's first K1 and K3 calls held against their plain versions.
    Returns the K1 (layered f32) and K3 launches of the whole phase and,
    per kernel, (calls held, largest error)."""
    held = {}
    _reset_counts()
    _sim_cases([(cid, ()) for cid in SIM_CASES], held)
    launches = _counts()
    if sorted(held) != sorted(launches):
        raise AssertionError(f"simulators: kernels held against plain {sorted(held)}, "
                             f"launched {launches}")
    print(f"simulators: {len(SIM_CASES)} cases passed; launches {launches}; held against "
          f"plain (calls, max abs err): {held}")
    return {"launches": launches, "held": held}


def _bench_channel(tx: torch.Tensor, gen) -> torch.Tensor:
    """The bench's channel (tools/bench_launch.py::receiver): tx + 0.1 x the
    antennas flipped + 0.05 x complex noise."""
    noise = torch.complex(torch.randn(tx.shape, generator=gen, device=tx.device),
                          torch.randn(tx.shape, generator=gen, device=tx.device))
    return tx + 0.1 * tx.flip(1) + 0.05 * noise


def _decoded(tag: str, out: dict, tb: torch.Tensor) -> None:
    n_ok = int(out["tb_ok"].sum())
    if n_ok != tb.shape[0] or not torch.equal(out["tb_bits"], tb):
        raise AssertionError(f"{tag}: {n_ok}/{tb.shape[0]} TBs pass CRC, bits equal: "
                             f"{torch.equal(out['tb_bits'], tb)}")


def _gnb_slot(dev, gen, held: dict, card: str) -> dict:
    """Phase 8 (a): the 273-PRB 2-layer DL slot (pdsch_tx, the bench's
    channel, pdsch_rx at 2 UE antennas) beside phase 4's UL receiver."""
    rcv = bench_launch.receiver(dev, gen)
    dl = pdsch.PdschConfig(mu=1, n_prb=273, mcs=16, n_layers=2, n_rx=2,
                           decoder_backend="kernel", decoder_check_every=1)
    tb = torch.randint(0, 2, (B, dl.tbs), generator=gen, device=dev, dtype=torch.int8)
    tx, _ = pdsch.pdsch_tx(dl, tb)
    rx = _bench_channel(tx, gen)
    lines = []
    _reset_counts()
    with _held_to_plain("gNB slot", held, lines, limit=2):
        out_dl = pdsch.pdsch_rx(dl, rx, n_iters=N_ITERS)
        out_ul = pusch.pusch_rx(rcv.cfg, rcv.rx, n_iters=N_ITERS)
        torch.cuda.synchronize()
    launches = _counts()
    if launches["pusch_frontend"] != 2 or launches["layered_f32"] < 2:
        raise AssertionError(f"gNB slot: launches {launches}, want K3 twice (DL, UL) and K1")
    _decoded("gNB slot DL", out_dl, tb)
    _decoded("gNB slot UL", out_ul, rcv.tb)
    print(f"gNB slot: DL 273 PRB MCS16 2 layers to 2 UE antennas B={B}: {B}/{B} TBs pass CRC "
          f"and equal the sent bits; UL {B}/{B}; launches {launches}")
    for line in lines:
        print(f"  {line}")

    def step():
        pdsch.pdsch_tx(dl, tb)
        return pusch.pusch_rx(rcv.cfg, rcv.rx, n_iters=N_ITERS)

    x = torch.ones((8, 128), device=dev)
    ms = statistics.median(_time_ms(step, N_TIMED) for _ in range(N_WINDOWS))
    p, _ = dl.seg_params()
    g = ldpc.build_graph(p.bg, p.Z)
    cbs = torch.zeros((B * p.C, p.K), dtype=torch.int8, device=dev)
    n_cols = rate_matching.tx_cols_needed(g, 0, tuple(dl.cb_e_sizes()), p.F, ncb=dl.ncb())
    tx_ms, enc_ms = (statistics.median(_time_ms(fn, N_TIMED) for _ in range(N_WINDOWS))
                     for fn in (lambda: pdsch.pdsch_tx(dl, tb),
                                lambda: ldpc.encode(g, cbs, n_cols=n_cols)))
    mul_us = statistics.median(bench_launch.host_us(lambda: torch.mul(x, 2))
                               for _ in range(N_WINDOWS))
    print(f"gNB slot (DL pdsch_tx + UL pusch_rx per {B}-slot batch): {B * 1000.0 / ms:.1f} "
          f"slots/s ({ms:.4f} ms per batch; pdsch_tx alone {tx_ms:.4f}, its LDPC encode of "
          f"{B * p.C} code blocks {enc_ms:.4f}; CUDA events, medians of {N_WINDOWS} windows of "
          f"{N_TIMED} batches); torch.mul(x, 2) host {mul_us:.3f} us; host-bound, information "
          f"only, on {card}")
    return {"launches": launches, "slots_per_s": B * 1000.0 / ms}


def _misc8_wide(dev, gen, held: dict, card: str) -> dict:
    """Phase 8 (b): misc8's branches at 273 PRB, MCS 16, 2x2, B = 8 through
    K1 on the unfused chain."""
    cfg = pusch.PuschConfig(**MISC8_WIDE)
    if fe.supported(cfg):
        raise AssertionError("misc8 at width: K3's supported admits a re-map configuration")
    tb = torch.randint(0, 2, (B, cfg.tbs), generator=gen, device=dev, dtype=torch.int8)
    tx, _ = pusch.pusch_tx(cfg, tb)
    rx = _bench_channel(tx, gen)
    lines = []
    _reset_counts()
    with _held_to_plain("misc8 at 273 PRB", held, lines, limit=1):
        out = pusch.pusch_rx(cfg, rx, n_iters=N_ITERS)
        torch.cuda.synchronize()
    launches = _counts()
    _check_kernels("misc8 at 273 PRB", launches["layered_f32"], launches["pusch_frontend"],
                   True, False)
    _decoded("misc8 at 273 PRB", out, tb)
    p, _ = cfg.seg_params()
    print(f"misc8 at 273 PRB MCS16 2x2 (3 DMRS symbols carrying data, PTRS L=2 K=2) B={B}: "
          f"{B}/{B} TBs pass CRC and equal the sent bits ({B * p.C} code blocks, G={cfg.G}, "
          f"TBS {cfg.tbs}); launches {launches}")
    for line in lines:
        print(f"  {line}")
    re_grid = extract_from_grid(cfg.fp, ofdm_demodulate(cfg.fp, rx, cfg.slot))
    ms = statistics.median(_time_ms(lambda: pusch.pusch_rx(cfg, rx, n_iters=N_ITERS), N_TIMED)
                           for _ in range(N_WINDOWS))
    h, nvar = pusch.pusch_channel_estimate(cfg, re_grid)
    x, mag = pusch.pusch_equalize(cfg, re_grid, h, nvar)
    stages = {
        "frontend": lambda: pusch.pusch_frontend(cfg, re_grid),
        "estimate": lambda: pusch.pusch_channel_estimate(cfg, re_grid),
        "MMSE on the RE map": lambda: pusch.pusch_equalize(cfg, re_grid, h, nvar),
        "PTRS, LLRs, descrambling": lambda: pusch.pusch_llrs(cfg, re_grid, x, mag, h),
    }
    stage_ms = {k: statistics.median(_time_ms(fn, N_TIMED) for _ in range(N_WINDOWS))
                for k, fn in stages.items()}
    print(f"misc8 at 273 PRB: {B * 1000.0 / ms:.1f} slots/s ({ms:.4f} ms per {B}-slot batch, "
          f"CUDA events, median of {N_WINDOWS} windows of {N_TIMED} batches); its unfused "
          f"frontend, ms per batch: " + ", ".join(f"{k} {v:.4f}" for k, v in stage_ms.items())
          + f"; on {card}")
    return {"launches": launches, "slots_per_s": B * 1000.0 / ms}


def _pdsch_2cw(dev, gen, held: dict) -> dict:
    """Phase 8 (c): a 2-codeword PDSCH round trip through K1 (Pdsch2CwConfig's
    defaults: 24 PRB, MCS 9 + 9, 6 layers, 8 RX, double-symbol DMRS)."""
    cfg = pdsch.Pdsch2CwConfig(decoder_backend="kernel")
    c0, c1 = cfg.cw_cfgs()
    tbs = [torch.randint(0, 2, (B, c.tbs), generator=gen, device=dev, dtype=torch.int8)
           for c in (c0, c1)]
    tx = pdsch.pdsch2cw_tx(cfg, *tbs)
    H = (torch.eye(cfg.n_rx, cfg.n_layers, dtype=torch.complex64, device=dev)
         + 0.1 * torch.complex(torch.randn((cfg.n_rx, cfg.n_layers), generator=gen, device=dev),
                               torch.randn((cfg.n_rx, cfg.n_layers), generator=gen, device=dev)))
    rx = torch.einsum("rl,bls->brs", H, tx)
    rx = add_noise(gen, rx, ulsim.noise_variance(c0, tx, 20.0))
    lines = []
    k1_0, k3_0 = ldpc_decoder.launches["layered_f32"], fe.launches
    with _held_to_plain("2-codeword PDSCH", held, lines):
        outs = pdsch.pdsch2cw_rx(cfg, rx, n_iters=15)
    k1, k3 = ldpc_decoder.launches["layered_f32"] - k1_0, fe.launches - k3_0
    for i, (out, tb) in enumerate(zip(outs, tbs)):
        _decoded(f"2-codeword PDSCH codeword {i}", out, tb)
    _check_kernels("2-codeword PDSCH", k1, k3, True, False)
    print(f"simulator 2-codeword PDSCH 6 layers 8 RX 24 PRB MCS 9 + 9 at 20 dB: {B}/{B} TBs of "
          f"each codeword pass CRC and equal the sent bits; launches K1 {k1}, K3 {k3}")
    for line in lines:
        print(f"  {line}")


def _dft_s_ofdm(dev, held: dict) -> None:
    """Phase 8 (c): a DFT-s-OFDM PUSCH (ulsim-mcs9-sc-fdma's operating point,
    75 PRB, MCS 9, 7 dB, 64 trials) through run_sweep with K1."""
    cfg = pusch.PuschConfig(mu=1, n_prb=75, mcs=9, transform_precoding=True,
                            decoder_backend="kernel")
    lines = []
    k1_0, k3_0 = ldpc_decoder.launches["layered_f32"], fe.launches
    with _held_to_plain("DFT-s-OFDM", held, lines):
        res, ok = ulsim.run_sweep(cfg, [7.0], 64, 64, eff_tp_check=99.0, verbose=False,
                                  device=dev)
    k1, k3 = ldpc_decoder.launches["layered_f32"] - k1_0, fe.launches - k3_0
    print(f"simulator DFT-s-OFDM 75 PRB MCS 9 1x1 at 7 dB: BLER {res[-1]['bler']:.6f}, "
          f"eff TP {res[-1]['eff_throughput_pct']:.2f}% over {res[-1]['trials']} trials; "
          f"launches K1 {k1}, K3 {k3}")
    for line in lines:
        print(f"  {line}")
    if not ok:
        raise AssertionError("DFT-s-OFDM: below 99 % effective throughput at 7 dB")
    _check_kernels("DFT-s-OFDM", k1, k3, True, False)


def phase_slice8(dev, gen, card: str, main_slots_per_s: float) -> dict:
    """Phase 8: the gNB slot, misc8's branches at width, the simulator cases."""
    held = {}
    gnb = _gnb_slot(dev, gen, held, card)
    wide = _misc8_wide(dev, gen, held, card)
    _reset_counts()
    _sim_cases(SIM_CASES_8, held)
    _pdsch_2cw(dev, gen, held)
    _dft_s_ofdm(dev, held)
    sims = _counts()
    launches = {k: gnb["launches"][k] + wide["launches"][k] + sims[k] for k in sims}
    if sorted(held) != sorted(launches):
        raise AssertionError(f"phase 8: kernels held against plain {sorted(held)}, "
                             f"launched {launches}")
    print(f"phase 8: gNB slot {gnb['slots_per_s']:.1f} slots/s, misc8 at 273 PRB "
          f"{wide['slots_per_s']:.1f} slots/s (the main path in phase 4: "
          f"{main_slots_per_s:.1f}); {len(SIM_CASES_8) + 2} simulator cases passed; "
          f"launches {launches}; held against plain (calls, max abs err): {held}")
    return {"launches": launches, "held": held}


def _med_ms(fn, calls: int = N_TIMED_9) -> float:
    """ms per call of fn by CUDA events, median of N_WINDOWS windows."""
    return statistics.median(_time_ms(fn, calls) for _ in range(N_WINDOWS))


def _bits(gen, shape) -> torch.Tensor:
    return torch.randint(0, 2, shape, generator=gen, device=gen.device, dtype=torch.int8)


def _uci_wide(dev, gen, held: dict, card: str, main_slots_per_s: float) -> dict:
    """Phase 9 (a): UCI on PUSCH at 273 PRB, MCS 16, 2x2, B = 8 through K3
    and K1, for each of UCI_WIDE; every call of both held against its plain
    version."""
    cfg = pusch.PuschConfig(**UCI_WIDE_PUSCH)
    launches = {"layered_f32": 0, "pusch_frontend": 0}
    for kw in UCI_WIDE:
        ucfg = uci_on_pusch.UciOnPuschConfig(**kw)
        tag = (f"UCI on PUSCH {cfg.n_prb} PRB MCS16 2x2 B={B}, ACK {kw['n_ack_bits']} "
               f"({'punctures' if ucfg.ack_punctures else 'rate-matched'}), CSI-1 "
               f"{kw['n_csi1_bits']}, CSI-2 {kw['n_csi2_bits']}")
        tb = _bits(gen, (B, cfg.tbs))
        sent = {name: _bits(gen, (B, n)) for name, n in zip(("ack", "csi1", "csi2"), kw.values())}
        tx, _ = pusch.pusch_tx(cfg, tb, uci_cfg=ucfg, ack_bits=sent["ack"],
                               csi1_bits=sent["csi1"], csi2_bits=sent["csi2"])
        rx = _bench_channel(tx, gen)
        lines = []
        _reset_counts()
        with _held_to_plain(tag, held, lines, limit=1 << 30):
            out = pusch.pusch_rx(cfg, rx, n_iters=N_ITERS, uci_cfg=ucfg)
            torch.cuda.synchronize()
        c = _counts()
        _check_kernels(tag, c["layered_f32"], c["pusch_frontend"], True, True)
        _decoded(tag, out, tb)
        for name, bits in sent.items():
            if not (bool(out["uci"][name + "_ok"].all()) and torch.equal(out["uci"][name], bits)):
                raise AssertionError(f"{tag}: {name} not recovered "
                                     f"({int(out['uci'][name + '_ok'].sum())}/{B} ok)")
        if not torch.equal(out["ack_bits"], sent["ack"]):
            raise AssertionError(f"{tag}: ack_bits differ from the sent ACK")
        launches = {k: launches[k] + c[k] for k in launches}
        g = ucfg.g_sizes(cfg)
        print(f"{tag}: {B}/{B} TBs pass CRC and equal the sent bits, ACK, CSI-1 and CSI-2 "
              f"recovered with their ok flags (G_ack {g[0]}, G_csi1 {g[1]}, G_csi2 {g[2]}, "
              f"G_data {g[3]}); launches {c}")
        for line in lines:
            print(f"  {line}")
        ms = _med_ms(lambda: pusch.pusch_rx(cfg, rx, n_iters=N_ITERS, uci_cfg=ucfg))
        print(f"{tag}: {B * 1000.0 / ms:.1f} slots/s ({ms:.4f} ms per {B}-slot batch, CUDA "
              f"events, median of {N_WINDOWS} windows of {N_TIMED_9} batches; the main path in "
              f"phase 4: {main_slots_per_s:.1f} slots/s) on {card}")
    # one polar SCL decode (list 8) of the last run's CSI-2 stream, B = 8
    streams = uci_on_pusch.demux_uci_llrs(cfg, ucfg, pusch.pusch_frontend(
        cfg, extract_from_grid(cfg.fp, ofdm_demodulate(cfg.fp, rx, cfg.slot))))
    E = streams["csi2"].shape[-1]
    scl_ms = _med_ms(lambda: pucch.uci_decode(40, E, streams["csi2"]))
    p = pucch._uci_code(40, E)[1]
    print(f"polar SCL decode (list 8) of the CSI-2 stream, K {p.K} E {E} N {p.N}, B={B}: "
          f"{scl_ms:.4f} ms per decode (CUDA events, median of {N_WINDOWS} windows of "
          f"{N_TIMED_9}) on {card}")
    return {"launches": launches, "scl_ms": scl_ms}


def _pdcch_wide(dev, gen, card: str) -> None:
    """Phase 9 (b): a DCI at AL 16 found by the blind search (ALs 4, 8, 16)
    over a 270-PRB interleaved CORESET, 2 RX, B = 8."""
    cs = pdcch.CoresetConfig(n_prb=270, interleaved=True, reg_bundle_size=6, interleaver_rows=3,
                             shift=7)
    rnti, n_id = 0x4601, 11
    cce0 = pdcch.search_space_candidates(cs, 16, 1, rnti=rnti, css=False)[0]
    dci = pdcch.DciConfig(A=39, aggregation_level=16, rnti=rnti, n_id=n_id, coreset=cs,
                          cce_index=cce0)
    pay = _bits(gen, (B, 39))
    grid = pdcch.pdcch_tx_grid(dci, pay)
    rx = grid[:, None] * flat_gain(gen, (B, 2, 1), False) + 0.1 * _complex_normal(
        gen, (B, 2, grid.shape[-1]))
    kw = dict(aggregation_levels=(4, 8, 16), candidates_per_al=(2, 2, 1), n_id=n_id, coreset=cs,
              css=False)
    bits, found, al = pdcch.blind_search(rx, 39, rnti, **kw)
    if not (bool(found.all()) and bool((al == 16).all()) and torch.equal(bits, pay)):
        raise AssertionError(f"PDCCH blind search: found {int(found.sum())}/{B}, AL {al.tolist()}")
    ms = _med_ms(lambda: pdcch.blind_search(rx, 39, rnti, **kw), 1)
    print(f"PDCCH blind search over a 270-PRB interleaved CORESET (45 CCEs), ALs 4, 8, 16 "
          f"(5 candidates), 2 RX, B={B}: {B}/{B} DCIs found at AL 16 and equal to the sent; "
          f"{ms:.4f} ms per batch on {card}")


def _ssb_wide(dev, gen, card: str) -> None:
    """Phase 9 (b): SSB generate/receive and initial_sync with cfo_scan=1 on
    a 273-PRB mu=1 stream (FFT 4096), B = 8; the PBCH decoded from the
    corrected stream."""
    cfg = pbch.PbchConfig(n_id=321, i_ssb=0, lmax=8)
    fp = make_frame_params(1, 273)
    pay = _bits(gen, (B, 32))
    tile = pbch.ssb_generate(cfg, pay)
    rx = tile[:, None] * flat_gain(gen, (B, 2, 1, 1), False) + 0.3 * _complex_normal(
        gen, (B, 2, 4, 240))
    got, ok = pbch.ssb_receive(cfg, rx)
    if not (bool(ok.all()) and torch.equal(got, pay)):
        raise AssertionError(f"SSB receive: {int(ok.sum())}/{B} CRC ok")
    gen_ms = _med_ms(lambda: pbch.ssb_generate(cfg, pay))
    rx_ms = _med_ms(lambda: pbch.ssb_receive(cfg, rx))
    # the SSB at sample 1000 of a stream at 10 dB, rotated by 0.37 SCS
    ssb = sync.ssb_time_signal(fp, tile)
    n, off, cfo = ssb.shape[-1] + 3000, 1000, 0.37 * fp.scs
    sigma = float(torch.sqrt(torch.mean(ssb.abs() ** 2))) * 10 ** (-10 / 20)
    stream = sigma * _complex_normal(gen, (B, n)) / 2 ** 0.5
    stream[:, off: off + ssb.shape[-1]] += ssb
    t = torch.arange(n, dtype=torch.float64, device=dev) / fp.sample_rate
    stream = (stream * torch.polar(torch.ones_like(t), 2 * math.pi * cfo * t)).to(torch.complex64)
    out = sync.initial_sync(fp, stream, cfo_scan=1)
    err = float((out["cfo_hz"] - cfo).abs().max())
    if not (bool((out["t0"] == off).all()) and bool((out["n_id"] == 321).all())
            and err < 0.02 * fp.scs):
        raise AssertionError(f"initial_sync: t0 {out['t0'].tolist()}, n_id {out['n_id'].tolist()}, "
                             f"CFO error {err:.1f} Hz")
    sym = out["samples_corrected"][:, off: off + 4 * fp.fft_size].reshape(B, 4, fp.fft_size)
    bins = torch.as_tensor(sync._ssb_bins(fp, 0, 0, sync.SSB_SC), device=dev)
    rx_tile = (torch.fft.fft(sym, dim=-1) / fp.fft_size ** 0.5)[..., bins]
    got, ok = pbch.ssb_receive(cfg, rx_tile[:, None])
    if not (bool(ok.all()) and torch.equal(got, pay)):
        raise AssertionError(f"PBCH from the synchronized stream: {int(ok.sum())}/{B} CRC ok")
    sync_ms = _med_ms(lambda: sync.initial_sync(fp, stream, cfo_scan=1))
    print(f"SSB (Lmax 8) B={B}: generate {gen_ms:.4f} ms, receive (2 RX, SCL 8) {rx_ms:.4f} ms "
          f"per batch, {B}/{B} payloads equal; initial_sync with cfo_scan=1 on a 273-PRB mu=1 "
          f"stream (FFT 4096, {n} samples): t0, N_ID equal, CFO error {err:.1f} Hz (SCS "
          f"{fp.scs}), the PBCH decoded from the corrected stream; {sync_ms:.4f} ms per batch "
          f"on {card}")


def _pucch_prach_wide(dev, gen, card: str) -> None:
    """Phase 9 (b): PUCCH F0, F1, F2 (16 PRB, 64 bits), F3 (11 bits, 4 PRB)
    at B = 64 and PRACH A2 at 273 PRB (64 preambles) at B = 32, each at a
    high SNR: no error, ms per batch of the receiver."""
    cases = (("F0 2 bits", pucch.Pucch0Config(n_bits=2)),
             ("F1 2 bits", pucch.Pucch1Config(n_bits=2)),
             ("F2 64 bits 16 PRB (polar)", pucch.Pucch2Config(n_bits=64, n_prb=16)),
             ("F3 11 bits 4 PRB", pucch.Pucch34Config(fmt=3, n_bits=11, n_prb=4)))
    parts = []
    for name, cfg in cases:
        uci = pucchsim.draw_uci(cfg, B_PUCCH, gen)
        h = flat_gain(gen, (B_PUCCH, 1, 1, 1), False)
        noise = _complex_normal(gen, (B_PUCCH, 1, *pucchsim.tx_shape(cfg))) / 2 ** 0.5
        errs = pucchsim.trial(cfg, uci, h, noise, 10.0)
        if bool(errs.any()):
            raise AssertionError(f"PUCCH {name}: {int(errs.sum())}/{B_PUCCH} errors at 10 dB")
        tx_fn, rx_fn = pucchsim._tx_rx(cfg)
        rx = (h * tx_fn(cfg, uci)[:, None] + 10 ** (-10 / 20) * noise).to(torch.complex64)
        parts.append(f"{name} {_med_ms(lambda: rx_fn(cfg, rx)):.4f}")
    print(f"PUCCH B={B_PUCCH} at 10 dB, every UCI equal to the sent; receiver ms per batch: "
          + ", ".join(parts) + f" on {card}")
    args = prachsim.parse_args(["-a", "-R", "273"])
    cfg, n_pre = prachsim.config(args)
    pre = torch.randint(0, n_pre, (B_PRACH,), generator=gen, device=dev)
    h = flat_gain(gen, (B_PRACH, 1, 1), False)
    noise = _complex_normal(gen, (B_PRACH, 1, cfg.n_samples))
    misses = prachsim.trial(cfg, pre, h, noise, -10.0, args.n_rb)
    if bool(misses.any()):
        raise AssertionError(f"PRACH A2 273 PRB: {int(misses.sum())}/{B_PRACH} missed at -10 dB")
    rx = (h * prach.prach_td_tx(cfg, pre)[:, None]).to(torch.complex64)
    ms = _med_ms(lambda: prach.prach_td_rx(cfg, rx))
    print(f"PRACH format {cfg.fmt} at 273 PRB (fs {cfg.sample_rate / 1e6:.2f} MHz, {cfg.n_samples} "
          f"samples), {n_pre} preambles on {len(cfg.roots)} roots, B={B_PRACH}: every preamble "
          f"detected at -10 dB; prach_td_rx {ms:.4f} ms per batch on {card}")


def phase_slice9(dev, gen, card: str, main_slots_per_s: float) -> dict:
    """Phase 9: UCI on PUSCH at width through K3 and K1, the control
    channels at their real sizes, the control simulators' cases."""
    t0 = time.perf_counter()
    held = {}
    uci = _uci_wide(dev, gen, held, card, main_slots_per_s)
    _pdcch_wide(dev, gen, card)
    _ssb_wide(dev, gen, card)
    _pucch_prach_wide(dev, gen, card)
    _reset_counts()
    _sim_cases(SIM_CASES_9, held)
    sims = _counts()
    if any(sims.values()):
        raise AssertionError(f"phase 9 simulators launched {sims}; they take neither K1 nor K3")
    launches = uci["launches"]
    if sorted(held) != sorted(launches) or any(held[k][0] != n for k, n in launches.items()):
        raise AssertionError(f"phase 9: launches {launches}, calls held {held}")
    print(f"phase 9: UCI on PUSCH through K3 and K1 (launches {launches}, each call held "
          f"against plain (calls, max abs err): {held}); control channels at their real sizes; "
          f"{len(SIM_CASES_9)} simulator cases passed without K1 or K3; "
          f"{time.perf_counter() - t0:.1f} s")
    return {"launches": launches, "held": held}


# slice 10: the gNB and UE slots at the main path's width (phase 10 a, b)
SLOT_PRB = 273
SLOT_RNTI = 0x4601
SLOT_PDSCH = dict(mu=1, n_prb=253, prb_start=20, n_bwp_prb=SLOT_PRB, mcs=16, rnti=SLOT_RNTI,
                  start_symbol=2, n_symbols=12, dmrs_symbols=(2,))   # PRB 0-19: the SSB
SLOT_PUSCH = dict(UCI_WIDE_PUSCH, n_symbols=13)                     # symbol 13: PUCCH
SLOT_CORESET_PRB = 270
SLOT_PUCCH_PRB = (100, 200)     # PUCCH F0, and the first of F2's 4 PRB
SRS_PRB = 272
N_TIMED_10 = 2            # calls in a phase-10 window (host-bound slots)
LTE_CASES = (("lte-dlsim-mcs10", ()), ("lte-ulsim-mcs16-2rx", ()))
LTE_WIDE = dict(n_rb=100, n_prb=100, mcs=28, n_rx=2)               # 20 MHz, C = 13


def _once_ms(fn) -> float:
    """ms of single calls of fn by CUDA events, median of N_WINDOWS (for the
    calls that take seconds; the correctness run before warmed them up)."""
    times = []
    for _ in range(N_WINDOWS):
        torch.cuda.synchronize()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def _two_rx(tx: torch.Tensor, gen) -> torch.Tensor:
    """(B, 1, samples) -> (B, 2, samples): a second antenna at 0.6 + 0.3j,
    then the bench's channel."""
    w = torch.tensor([1.0, 0.6 + 0.3j], dtype=torch.complex64, device=tx.device)
    return _bench_channel(tx * w[:, None], gen)


def _grant_dci(dev) -> torch.Tensor:
    """(B, DCI_A) bits of the grant of SLOT_PDSCH's allocation, MCS 16."""
    bits = ue.encode_grant(mcs=SLOT_PDSCH["mcs"], prb_start=SLOT_PDSCH["prb_start"],
                           n_prb=SLOT_PDSCH["n_prb"])
    return torch.as_tensor(bits, device=dev).expand(B, -1).contiguous()


def _dl_slot_cfg(n_layers: int, dci_al: int):
    """Phase 10's DL slot: a PDSCH of n_layers on PRB 20-272, the SSB on
    PRB 0-19 at symbols 8-11, the grant DCI (AL dci_al) in a 270-PRB CORESET
    at symbol 0, a CSI-RS over the BWP at symbol 1 (n_layers ports)."""
    pd = pdsch.PdschConfig(n_layers=n_layers, n_rx=2, decoder_backend="kernel",
                           decoder_check_every=1, **SLOT_PDSCH)
    dl = gnb.SlotDlConfig(
        mu=1, n_bwp_prb=SLOT_PRB, pdsch=(pd,),
        ssb=gnb.SsbPdu(pbch.PbchConfig(n_id=321, i_ssb=0, lmax=8), prb_offset=0, start_symbol=8),
        pdcch=(gnb.PdcchPdu(pdcch.DciConfig(A=ue.DCI_A, aggregation_level=dci_al, rnti=SLOT_RNTI,
                                            coreset_prb=SLOT_CORESET_PRB)),),
        csirs=(gnb.CsirsPdu(csirs.CsirsConfig(n_prb=SLOT_PRB, symbol=1, n_ports=n_layers)),))
    return pd, dl


def _slot_gnb(dev, gen, held: dict, card: str) -> dict:
    """Phase 10 (a): the gNB slot at 273 PRB, B = 8: the DL slot composed and
    sent (2-layer PDSCH, SSB, PDCCH, 2-port CSI-RS) and received by a 2-RX UE
    (PDSCH through K3 and K1, the MIB, the CSI-RS); the UL slot received by
    gnb_ul_slot (the main path's PUSCH on symbols 0-12 through K3 and K1,
    PUCCH F0 and F2 on symbol 13, a PRACH occasion)."""
    fp = make_frame_params(1, SLOT_PRB)
    pd, dl = _dl_slot_cfg(2, 8)
    tb = _bits(gen, (B, pd.tbs))
    mib = _bits(gen, (B, 32))
    dci = _grant_dci(dev)
    tx, _ = gnb.gnb_dl_slot(dl, [tb], mib, dci_payloads=[dci])
    rx = _bench_channel(tx, gen)
    pu = pusch.PuschConfig(**SLOT_PUSCH)
    p0 = pucch.Pucch0Config(n_bits=2)
    p2 = pucch.Pucch2Config(n_bits=16, n_prb=4)
    prb0, prb2 = SLOT_PUCCH_PRB
    ul = gnb.SlotUlConfig(mu=1, n_bwp_prb=SLOT_PRB, pusch=(pu,), pucch0=((p0, prb0),),
                          pucch2=((p2, prb2),), prach=(prach.PrachConfig(),))
    tbu, csi = _bits(gen, (B, pu.tbs)), _bits(gen, (B, 16))
    ack = torch.randint(0, 4, (B,), generator=gen, device=dev)
    pre = torch.randint(0, 64, (B,), generator=gen, device=dev)

    def ul_tx():
        g, _ = pusch.pusch_tx_grid(pu, tbu)
        g = gnb.place_pucch_tile(g, pucch.pucch0_tx(p0, ack), p0, prb0)
        g[:, 0, 13, 12 * prb2: 12 * (prb2 + 4)] += pucch.pucch2_tx(p2, csi)[:, 0]
        return ofdm.ofdm_modulate(fp, ofdm.map_to_grid(fp, g), 0)

    rx_ul = _bench_channel(ul_tx(), gen)
    occ = prach.prach_tx(ul.prach[0], pre)[:, None]
    pf = occ * torch.tensor([1.0, 0.5 - 0.5j], dtype=torch.complex64, device=dev)[:, None] \
        + 0.1 * _complex_normal(gen, (B, 2, occ.shape[-1]))
    lines = []
    _reset_counts()
    with _held_to_plain("phase 10 gNB slot", held, lines, limit=1 << 30):
        out_dl = pdsch.pdsch_rx(pd, rx, n_iters=N_ITERS)
        out_ul = gnb.gnb_ul_slot(ul, rx_ul, n_iters=N_ITERS, prach_freq=pf)
        torch.cuda.synchronize()
    c = _counts()
    if c["pusch_frontend"] != 2 or c["layered_f32"] < 2:
        raise AssertionError(f"gNB slot at {SLOT_PRB} PRB: launches {c}, want K3 twice "
                             f"(DL, UL) and K1")
    _decoded("phase 10 DL PDSCH", out_dl, tb)
    _decoded("phase 10 UL PUSCH", {"tb_ok": out_ul["crc_indication"][0]["tb_ok"],
                                   "tb_bits": out_ul["rx_data"][0]}, tbu)
    grid = extract_from_grid(fp, ofdm_demodulate(fp, rx, 0))
    got_mib, mib_ok = pbch.ssb_receive(dl.ssb.cfg, grid[:, :, 8:12, :240])
    meas = csirs.csi_measure_2port(dl.csirs[0].cfg, grid[:, :, 1])
    u0, u2 = out_ul["uci0"][0]["uci"], out_ul["uci2"][0]
    ra = out_ul["rach_indication"][0]
    checks = {"MIB": bool(mib_ok.all()) and torch.equal(got_mib, mib),
              "CSI-RS": bool((meas["snr_db"] > 10).all()),
              "PUCCH F0": torch.equal(u0.long(), ack),
              "PUCCH F2": bool(u2["ok"].all()) and torch.equal(u2["uci"], csi),
              "PRACH": bool(ra["detected"].all()) and torch.equal(ra["preamble"].to(pre.dtype), pre)}
    if not all(checks.values()):
        raise AssertionError(f"gNB slot at {SLOT_PRB} PRB: recovered {checks}")
    print(f"gNB slot {SLOT_PRB} PRB B={B}: DL 2-layer PDSCH {pd.n_prb} PRB MCS16 {B}/{B} TBs, "
          f"MIB, CSI-RS (PMI {meas['pmi'].tolist()}, SNR >= {float(meas['snr_db'].min()):.1f} "
          f"dB); UL PUSCH {pu.n_prb} PRB 2x2 {B}/{B} TBs, PUCCH F0 2 bits, F2 16 bits, PRACH "
          f"{B}/{B} preambles recovered; launches {c}")
    for line in lines:
        print(f"  {line}")
    dl_tx_ms = _med_ms(lambda: gnb.gnb_dl_slot(dl, [tb], mib, dci_payloads=[dci]), N_TIMED_10)
    dl_rx_ms = _med_ms(lambda: pdsch.pdsch_rx(pd, rx, n_iters=N_ITERS), N_TIMED_10)
    ul_ms = _med_ms(lambda: gnb.gnb_ul_slot(ul, rx_ul, n_iters=N_ITERS, prach_freq=pf), N_TIMED_10)
    print(f"gNB slot {SLOT_PRB} PRB B={B}, ms per batch (CUDA events, median of {N_WINDOWS} "
          f"windows of {N_TIMED_10}): gnb_dl_slot {dl_tx_ms:.4f}, the UE's pdsch_rx "
          f"{dl_rx_ms:.4f}, gnb_ul_slot {ul_ms:.4f} on {card}")
    return {"launches": c, "ms": {"gnb_dl_slot": dl_tx_ms, "pdsch_rx": dl_rx_ms,
                                  "gnb_ul_slot": ul_ms}}


def _slot_ue(dev, gen, held: dict, card: str) -> dict:
    """Phase 10 (b): ue_receive_slot on the DL slot with a 1-layer PDSCH on
    PRB 20-272 (the UE model receives one layer): the blind search over
    the 270-PRB CORESET, the grant, the PDSCH through K3, not K1."""
    fp = make_frame_params(1, SLOT_PRB)
    pd, dl = _dl_slot_cfg(1, 8)
    tb = _bits(gen, (B, pd.tbs))
    dci = _grant_dci(dev)
    tx, _ = gnb.gnb_dl_slot(dl, [tb], _bits(gen, (B, 32)), dci_payloads=[dci])
    grid = extract_from_grid(fp, ofdm_demodulate(fp, _two_rx(tx, gen), 0))
    cfg = ue.UeConfig(mu=1, n_bwp_prb=SLOT_PRB, rnti=SLOT_RNTI, coreset_prb=SLOT_CORESET_PRB,
                      n_rx=2)
    lines = []
    _reset_counts()
    with _held_to_plain("phase 10 UE slot", held, lines, limit=1 << 30):
        out = ue.ue_receive_slot(cfg, grid, n_iters=N_ITERS)
        torch.cuda.synchronize()
    c = _counts()
    _check_kernels("phase 10 UE slot", c["layered_f32"], c["pusch_frontend"], False, True)
    if not (bool(out["dci_found"].all()) and bool((out["al"] == 8).all())
            and out["grant"] == ue.decode_grant(_grant_dci(dev)[0].cpu().numpy())):
        raise AssertionError(f"UE slot: DCI found {out['dci_found'].tolist()}, "
                             f"grant {out['grant']}")
    _decoded("phase 10 UE slot", out, tb)
    print(f"UE slot {SLOT_PRB} PRB B={B}: DCI found at AL 8 in the {SLOT_CORESET_PRB}-PRB CORESET, grant "
          f"{out['grant']}, {B}/{B} TBs recovered; launches {c}")
    for line in lines:
        print(f"  {line}")
    ms = _once_ms(lambda: ue.ue_receive_slot(cfg, grid, n_iters=N_ITERS))
    print(f"ue_receive_slot {SLOT_PRB} PRB B={B}: {ms:.4f} ms per batch (CUDA events, median "
          f"of {N_WINDOWS} single calls) on {card}")
    return {"launches": c, "ms": ms}


def _mu_srs_prs(dev, gen, held: dict, card: str) -> dict:
    """Phase 10 (c): MU-MIMO at 273 PRB through K1 (not K3), SRS with 2 ports
    over 272 PRB, PRS ToA at 273 PRB (FFT 4096, osf 8)."""
    cfgs = [dataclasses.replace(c, decoder_backend="kernel")
            for c in mu_mimo.mu_cfgs(SLOT_PRB, 0x1001, 0x1002, n_rx=2)]
    pmi = mu_mimo._ORTHO_PAIRS[0]
    tbs = [_bits(gen, (B, c.tbs)) for c in cfgs]
    tx = mu_mimo.mu_mimo_tx(*cfgs, *tbs, *pmi)
    rxs = [_bench_channel(tx, gen) for _ in cfgs]
    lines = []
    _reset_counts()
    with _held_to_plain("phase 10 MU-MIMO", held, lines, limit=1 << 30):
        outs = [mu_mimo.mu_mimo_rx(c, port, rx, n_iters=N_ITERS)
                for port, (c, rx) in enumerate(zip(cfgs, rxs))]
        torch.cuda.synchronize()
    c = _counts()
    _check_kernels("phase 10 MU-MIMO", c["layered_f32"], c["pusch_frontend"], True, False)
    for i, (out, tb) in enumerate(zip(outs, tbs)):
        _decoded(f"phase 10 MU-MIMO UE {i + 1}", out, tb)
    tx_ms = _med_ms(lambda: mu_mimo.mu_mimo_tx(*cfgs, *tbs, *pmi), N_TIMED_10)
    rx_ms = _med_ms(lambda: mu_mimo.mu_mimo_rx(cfgs[0], 0, rxs[0], n_iters=N_ITERS), N_TIMED_10)
    print(f"MU-MIMO {SLOT_PRB} PRB MCS {cfgs[0].mcs}, PMI pair {pmi}, B={B}: both UEs {B}/{B} "
          f"TBs through K1 (launches {c}); mu_mimo_tx {tx_ms:.4f} ms, mu_mimo_rx {rx_ms:.4f} ms "
          f"per batch")
    for line in lines:
        print(f"  {line}")
    # SRS: 2 ports over SRS_PRB through a flat 2x2 channel per slot
    scfg = srs.SrsConfig(n_prb=SRS_PRB, comb=2, u=3, n_ports=2)
    H = _complex_normal(gen, (B, 2, 2)) / 2 ** 0.5
    H[:, :, 0] *= 2.0                       # the first port stronger: a clear PMI
    sig = torch.einsum("brp,bpk->brk", H, srs.srs_tx(scfg, B, dev))
    srx = sig + 0.05 * _complex_normal(gen, sig.shape)
    rep = srs.srs_report(scfg, srx)
    W = torch.as_tensor(csirs.PMI_CODEBOOK_2TX, dtype=torch.complex64, device=dev)
    gains = torch.einsum("brp,ip->bir", H, W).abs().pow(2).sum(-1)      # (B, 4), the channel's
    picked = gains.gather(1, rep["pmi"].long()[:, None])[:, 0]
    if not (bool((picked >= 0.98 * gains.amax(-1)).all())
            and bool(torch.isfinite(rep["subband_snr_db"]).all())
            and bool((rep["wideband_snr_db"] > 10).all())):
        raise AssertionError(f"SRS: PMI {rep['pmi'].tolist()} (the channel's best "
                             f"{gains.argmax(-1).tolist()}), SNR {rep['wideband_snr_db'].tolist()}")
    srs_ms = _med_ms(lambda: srs.srs_report(scfg, srx))
    # PRS: fractional delays at the 4096-point grid's rate, 2 RX
    pcfg = prs.PrsConfig(n_prb=SLOT_PRB, comb_size=4, n_symbols=4, n_id_prs=42)
    n_sc, fft = 12 * SLOT_PRB, make_frame_params(1, SLOT_PRB).fft_size
    delay = torch.linspace(-20.0, 30.0, B, device=dev)
    k = torch.arange(n_sc, device=dev)
    ph = torch.polar(torch.ones((B, n_sc), device=dev), -2 * math.pi * k * delay[:, None] / fft)
    prx = (prs.prs_tx_grid(pcfg, B, n_sc, dev)[:, None] * ph[:, None, None]
           * flat_gain(gen, (B, 2, 1, 1), False) + 0.1 * _complex_normal(gen, (B, 2, 4, n_sc)))
    toa = prs.prs_toa(pcfg, prx, fft)["toa_samples"]
    err = float((toa - delay).abs().max())
    if not err < 0.5:
        raise AssertionError(f"PRS ToA: error {err:.3f} samples, toa {toa.tolist()}")
    prs_ms = _med_ms(lambda: prs.prs_toa(pcfg, prx, fft))
    print(f"SRS 2 ports {SRS_PRB} PRB comb 2, 2 RX, B={B}: PMI within 2% of the channel's best gain, "
          f"wideband SNR "
          f">= {float(rep['wideband_snr_db'].min()):.1f} dB, srs_report {srs_ms:.4f} ms; PRS "
          f"{SLOT_PRB} PRB comb 4, FFT {fft} x osf 8, B={B}: ToA within {err:.4f} samples of "
          f"the delay, prs_toa {prs_ms:.4f} ms per batch on {card}")
    return {"launches": c, "ms": {"mu_mimo_tx": tx_ms, "mu_mimo_rx": rx_ms, "srs_report": srs_ms,
                                  "prs_toa": prs_ms}}


def _lte(dev, gen, held: dict, card: str) -> dict:
    """Phase 10 (d): the LTE autotest cases in this process, one LTE PDSCH
    batch at 100 PRB, MCS 28 (B = 8), and one turbo decode at K = 6144
    (B = 8); none reaches K1 or K3."""
    _reset_counts()
    _sim_cases(LTE_CASES, held)
    cfg = lte_pdsch.LtePdschConfig(**LTE_WIDE)
    p = cfg.seg()
    tb = _bits(gen, (B, cfg.tbs))
    tx, _ = lte_pdsch.pdsch_tx(cfg, tb)
    rx = _two_rx(tx, gen)
    out = lte_pdsch.pdsch_rx(cfg, rx)
    _decoded("phase 10 LTE PDSCH", out, tb)
    tx_ms = _med_ms(lambda: lte_pdsch.pdsch_tx(cfg, tb), 1)
    rx_ms = _once_ms(lambda: lte_pdsch.pdsch_rx(cfg, rx))
    K = 6144
    d = turbo.encode(_bits(gen, (B, K)))
    llrs = [4.0 * (1.0 - 2.0 * x.float()) + 2.0 * torch.randn(x.shape, generator=gen, device=dev)
            for x in d]
    turbo.decode(*llrs)
    dec_ms = _once_ms(lambda: turbo.decode(*llrs))
    c = _counts()
    if any(c.values()):
        raise AssertionError(f"phase 10 LTE launched {c}; it takes neither K1 nor K3")
    print(f"LTE PDSCH {cfg.n_rb} PRB MCS {cfg.mcs} (TBS {cfg.tbs}, C={p.C}, K {p.k_minus}/"
          f"{p.k_plus}) 2 RX B={B}: {B}/{B} TBs; pdsch_tx {tx_ms:.4f} ms, pdsch_rx (6 turbo "
          f"iterations) {rx_ms:.4f} ms per batch; turbo decode K={K} B={B}, 6 iterations: "
          f"{dec_ms:.4f} ms (eager, {24 * (K + 3)} trellis steps; CUDA events, median of "
          f"{N_WINDOWS} single calls; pdsch_tx {N_WINDOWS} windows of 1) on {card}")
    return {"ms": {"lte_pdsch_tx": tx_ms, "lte_pdsch_rx": rx_ms, "turbo_decode": dec_ms}}


def phase_slice10(dev, gen, card: str) -> dict:
    """Phase 10: the gNB and UE slots at 273 PRB through K3 and K1, MU-MIMO,
    SRS and PRS at full width, and the LTE data plane."""
    t0 = time.perf_counter()
    held = {}
    a = _slot_gnb(dev, gen, held, card)
    b = _slot_ue(dev, gen, held, card)
    c = _mu_srs_prs(dev, gen, held, card)
    d = _lte(dev, gen, held, card)
    launches = {k: a["launches"][k] + b["launches"][k] + c["launches"][k]
                for k in ("layered_f32", "pusch_frontend")}
    if sorted(held) != sorted(launches) or any(held[k][0] != n for k, n in launches.items()):
        raise AssertionError(f"phase 10: launches {launches}, calls held {held}")
    print(f"phase 10: gNB slot, UE slot, MU-MIMO through K3 and K1 (launches {launches}, each "
          f"call held against plain (calls, max abs err): {held}); SRS, PRS; LTE "
          f"{len(LTE_CASES)} autotest cases and the 100-PRB PDSCH without K1 or K3; "
          f"{time.perf_counter() - t0:.1f} s")
    return {"launches": launches, "held": held,
            "ms": {**a["ms"], "ue_receive_slot": b["ms"], **c["ms"], **d["ms"]}}


# slice 11: the LTE control channels, NB-IoT and the lte-softmodem loop
LTE_RB = 100              # 20 MHz, the LTE channels' full width
LTE_CELL, LTE_SF = 17, 1
DCI_A_11 = 27             # the DCI size of the JAX package's PDCCH tests: L = A + 16 = 43
DCI_RNTIS = (0x5678, 0x1234)   # an AL-2 DCI at CCE 2 and an AL-8 DCI at CCE 8
B_PUCCH_11, B_PRACH_11 = 64, 32
SRS_SNR_DB = 15.0
# bins of the 1024-point delay a detection may miss by: the peak's bin (0.5)
# and the floor in its shift window's start (1)
PRACH_DELAY_TOL = 1.5
LTE_LOOP_CYCLES = 4
LTE_LOOP_RECORD = "LTE_LOOP_r5.txt"   # the JAX loop's lines; 10-14 hold its RRC line, cycles 0-3


def _lte_air(re: torch.Tensor, gen) -> torch.Tensor:
    """(N, 14, n_sc) LTE subframe REs at LTE_RB -> (N, 2, 14, n_sc): OFDM,
    the bench's 2-RX channel (_two_rx), OFDM demodulation."""
    fp = lte_params.make_lte_frame_params(LTE_RB)
    tx = lte_params.ofdm_modulate(fp, lte_params.map_to_grid(fp, re[:, None]))
    return lte_params.extract_from_grid(fp, lte_params.ofdm_demodulate(fp, _two_rx(tx, gen)))


def _two_rx_h(n: int, dev) -> torch.Tensor:
    """(n, 2, LTE_RB * 12) the flat channel of _two_rx: antenna r gets w_r +
    0.1 w_(1-r) of the one TX antenna, w = (1, 0.6 + 0.3j)."""
    h = torch.tensor([1.0 + 0.1 * (0.6 + 0.3j), 0.6 + 0.3j + 0.1], dtype=torch.complex64,
                     device=dev)
    return h[None, :, None].expand(n, 2, 12 * LTE_RB)


def _lte_downlink_control(dev, gen, card: str) -> dict:
    """Phase 11 (a): PBCH (4 frames, 1/2/4 ports), then one control symbol
    carrying PCFICH (CFI 1-3), PHICH (ACK, NACK) and two DCIs, all at 100 PRB
    over _two_rx with the channel known, B = 8; one Viterbi decode at L = 43."""
    ms = {}
    for ports in (1, 2, 4):
        cfg = lte_pbch.LtePbchConfig(n_rb=LTE_RB, cell_id=LTE_CELL, n_tx_ports=ports, n_rx=2)
        mib = _bits(gen, (B, 24))
        grids = lte_pbch.pbch_tx_grids(cfg, mib)                         # (B, 4, 14, n_sc)
        rx = _lte_air(grids.reshape(4 * B, 14, -1), gen).view(B, 4, 2, 14, -1)
        h = _two_rx_h(B, dev)
        got, ok, found = lte_pbch.pbch_rx_grids(cfg, rx, h)
        if not (bool(ok.all()) and torch.equal(got, mib) and bool((found == ports).all())):
            raise AssertionError(f"LTE PBCH {ports} ports: ok {ok.tolist()}, masks "
                                 f"{found.tolist()}, MIB equal {torch.equal(got, mib)}")
        ms[f"pbch_{ports}port"] = _med_ms(lambda: lte_pbch.pbch_rx_grids(cfg, rx, h))
    print(f"LTE PBCH {LTE_RB} PRB, 4 frames combined, 2 RX, B={B}: {B}/{B} MIBs with the mask "
          f"of 1, 2 and 4 ports; pbch_rx_grids " + ", ".join(
              f"{p} port(s) {ms[f'pbch_{p}port']:.4f}" for p in (1, 2, 4)) + f" ms on {card}")

    regs = lte_pdcch.symbol0_regs(LTE_RB, LTE_CELL)
    sc_pc = torch.as_tensor(regs[lte_pdcch.pcfich_reg_indices(LTE_RB, LTE_CELL)].reshape(-1),
                            device=dev)
    sc_ph = torch.as_tensor(regs[lte_pdcch.phich_reg_indices(LTE_RB, LTE_CELL)].reshape(-1),
                            device=dev)
    cfi = [1 + i % 3 for i in range(B)]
    ack = [i % 2 for i in range(B)]
    pays = [_bits(gen, (B, DCI_A_11)) for _ in DCI_RNTIS]
    row = (lte_pdcch.pdcch_tx_symbol0(LTE_RB, LTE_CELL, LTE_SF, pays[0], DCI_RNTIS[0], 2, 2)
           + lte_pdcch.pdcch_tx_symbol0(LTE_RB, LTE_CELL, LTE_SF, pays[1], DCI_RNTIS[1], 8, 8))
    row[:, sc_pc] = torch.stack([lte_pdcch.pcfich_encode(c, LTE_SF, LTE_CELL, dev) for c in cfi])
    row[:, sc_ph] = torch.stack([lte_pdcch.phich_encode(a, 0, dev) for a in ack])
    re = torch.zeros((B, 14, 12 * LTE_RB), dtype=torch.complex64, device=dev)
    re[:, 0] = row
    y0 = _lte_air(re, gen)[:, :, 0]                                      # (B, 2, n_sc)
    h = _two_rx_h(B, dev)

    def pcfich():
        return lte_pdcch.pcfich_decode(y0[..., sc_pc], h[..., sc_pc], LTE_SF, LTE_CELL)

    def phich():
        return lte_pdcch.phich_decode(y0[..., sc_ph], h[..., sc_ph])

    def search(rnti):
        return lte_pdcch.pdcch_blind_decode(y0, h, LTE_RB, LTE_CELL, LTE_SF, rnti, DCI_A_11)

    if pcfich().tolist() != cfi or phich().tolist() != ack:
        raise AssertionError(f"LTE PCFICH {pcfich().tolist()} (sent {cfi}), PHICH "
                             f"{phich().tolist()} (sent {ack})")
    levels = []
    for rnti, pay, al in zip(DCI_RNTIS, pays, (2, 8)):
        got, found, level = search(rnti)
        if not (bool(found.all()) and torch.equal(got, pay) and bool((level <= al).all())):
            raise AssertionError(f"LTE PDCCH RNTI {rnti:#x} (AL {al}): found {found.tolist()}, "
                                 f"levels {level.tolist()}, payload equal {torch.equal(got, pay)}")
        levels.append(sorted(set(level.tolist())))
    if bool(search(0x0BAD)[1].any()):
        raise AssertionError("LTE PDCCH: another RNTI found a DCI")
    ms.update(pcfich=_med_ms(pcfich), phich=_med_ms(phich),
              pdcch_blind_decode=_med_ms(lambda: search(DCI_RNTIS[1])))
    L = DCI_A_11 + 16
    bits = _bits(gen, (B, L))
    coded = lte_viterbi.encode(bits)
    llr = 4.0 * (1.0 - 2.0 * coded.float()) + 2.0 * torch.randn(coded.shape, generator=gen,
                                                                device=dev)
    if not torch.equal(lte_viterbi.decode(llr), bits):
        raise AssertionError(f"viterbi.decode at L={L}: bits differ from the sent ones")
    ms["viterbi_decode"] = _med_ms(lambda: lte_viterbi.decode(llr))
    n_cand = len(lte_pdcch._search_space(LTE_RB, LTE_CELL, LTE_SF, DCI_A_11, (1, 2, 4, 8), 6,
                                         None, dev)[0])
    print(f"LTE control symbol {LTE_RB} PRB, 2 RX, B={B}: PCFICH CFI {cfi}, PHICH {ack} "
          f"(0 = ACK) decoded; PDCCH blind search over {n_cand} candidates (ALs 1, 2, 4, 8): "
          f"the AL-2 DCI of {DCI_RNTIS[0]:#x} found at AL {levels[0]}, the AL-8 DCI of "
          f"{DCI_RNTIS[1]:#x} at AL {levels[1]} (a lower AL's candidate inside its CCEs decodes "
          f"first), payloads equal, another RNTI finds none; ms per batch: pcfich_decode "
          f"{ms['pcfich']:.4f}, phich_decode {ms['phich']:.4f}, pdcch_blind_decode "
          f"{ms['pdcch_blind_decode']:.4f}; viterbi.decode L={L} B={B}: {ms['viterbi_decode']:.4f} "
          f"ms ({3 * L} add-compare-select steps) on {card}")
    return ms


def _lte_uplink_control(dev, gen, card: str) -> dict:
    """Phase 11 (b): PUCCH 1a and 1b of 3 users on one PRB, PUCCH 2 with 4 and
    13 CQI bits (B = 64, over _two_rx), LTE PRACH formats 0-3 (64 preambles,
    a delay, 2 RX, B = 32) and SRS over 96 PRB (B = 8)."""
    ms = {}
    users = [lte_pucch.LtePucch1Config(n_rb=LTE_RB, cell_id=LTE_CELL, prb=1, n_oc=oc, cs0=cs,
                                       n_rx=2) for oc, cs in ((0, 0), (1, 2), (2, 4))]
    for n_bits, name in ((1, "1a"), (2, "1b")):
        bits = [_bits(gen, (B_PUCCH_11, n_bits)) for _ in users]
        grid = sum(lte_pucch.pucch1_tx(u, b) for u, b in zip(users, bits))
        rx = _lte_air(grid, gen)

        def rx_all():
            return [lte_pucch.pucch1_rx(u, rx, n_bits) for u in users]

        for u, b, out in zip(users, bits, rx_all()):
            if not (torch.equal(out["bits"], b) and bool(out["detected"].all())):
                raise AssertionError(f"LTE PUCCH {name} user n_oc={u.n_oc}: bits equal "
                                     f"{torch.equal(out['bits'], b)}, detected "
                                     f"{int(out['detected'].sum())}/{B_PUCCH_11}")
        ms[f"pucch{name}_3users"] = _med_ms(rx_all)
    for n_bits in (4, 13):
        cfg = lte_pucch.LtePucch2Config(n_rb=LTE_RB, cell_id=LTE_CELL, prb=2, cs0=3,
                                        n_bits=n_bits, n_rx=2)
        bits = _bits(gen, (B_PUCCH_11, n_bits))
        rx = _lte_air(lte_pucch.pucch2_tx(cfg, bits), gen)
        out = lte_pucch.pucch2_rx(cfg, rx)
        if not (torch.equal(out["uci"], bits) and bool(out["detected"].all())):
            raise AssertionError(f"LTE PUCCH 2 {n_bits} bits: equal "
                                 f"{torch.equal(out['uci'], bits)}, detected "
                                 f"{int(out['detected'].sum())}/{B_PUCCH_11}")
        ms[f"pucch2_{n_bits}bit"] = _med_ms(lambda: lte_pucch.pucch2_rx(cfg, rx))
    print(f"LTE PUCCH {LTE_RB} PRB, 2 RX, B={B_PUCCH_11}: 1a and 1b of 3 users on PRB 1 (cover "
          f"0/1/2), all bits and detections; format 2 with 4 and 13 CQI bits, all decoded; ms "
          f"per batch: " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()) + f" on {card}")

    tau = 5                                      # delay in samples of the 839-point sequence
    ramp = torch.exp(torch.tensor(-2j * math.pi * tau / 839, dtype=torch.complex64, device=dev)
                     * torch.arange(839, device=dev))
    w = torch.tensor([1.0, 0.6 + 0.3j], dtype=torch.complex64, device=dev)[:, None]
    want_delay = tau * 1024 / 839
    for fmt in range(4):
        cfg = lte_prach.LtePrachConfig(format=fmt, root_sequence_index=22, n_roots=1)
        if cfg.n_preambles != 64:
            raise AssertionError(f"LTE PRACH format {fmt}: {cfg.n_preambles} preambles")
        pre = torch.randint(0, 64, (B_PRACH_11,), generator=gen, device=dev)
        rx = (lte_prach.prach_tx(cfg, pre) * ramp)[:, None] * w \
            + 0.05 * _complex_normal(gen, (B_PRACH_11, 2, 839))
        out = lte_prach.prach_rx(cfg, rx)
        delay_err = float((out["delay"].float() - want_delay).abs().max())
        if not (bool(out["detected"].all()) and torch.equal(out["preamble"], pre)
                and delay_err <= PRACH_DELAY_TOL):
            raise AssertionError(f"LTE PRACH format {fmt}: detected "
                                 f"{int(out['detected'].sum())}/{B_PRACH_11}, preambles equal "
                                 f"{torch.equal(out['preamble'], pre)}, delay error {delay_err}")
        ms[f"prach_fmt{fmt}"] = _med_ms(lambda: lte_prach.prach_rx(cfg, rx))
    print(f"LTE PRACH formats 0-3, 64 preambles (root 22, Ncs 13), delay {tau} samples "
          f"({want_delay:.2f} at the 1024-point rate), 2 RX, B={B_PRACH_11}: every preamble found, "
          f"every delay within {PRACH_DELAY_TOL} of it; prach_rx ms per batch " + ", ".join(
              f"format {f} {ms[f'prach_fmt{f}']:.4f}" for f in range(4)) + f" on {card}")

    cfg = lte_srs.LteSrsConfig(n_rb=LTE_RB, srs_rb=96, rb_start=2, cell_id=LTE_CELL,
                               cyclic_shift=3, n_rx=2)
    h = _two_rx_h(B, dev)
    sigma2 = float((h[0, :, 0].abs() ** 2).mean()) / 10 ** (SRS_SNR_DB / 10)
    y = h * lte_srs.srs_tx(cfg, B, dev)[:, None] \
        + math.sqrt(sigma2 / 2) * _complex_normal(gen, (B, 2, 12 * LTE_RB))
    out = lte_srs.srs_rx(cfg, y)
    snr = out["snr_db"]
    if not bool(((snr - SRS_SNR_DB).abs() < 1.0).all()):
        raise AssertionError(f"LTE SRS: SNR {snr.tolist()} dB, set {SRS_SNR_DB}")
    ms["srs_rx"] = _med_ms(lambda: lte_srs.srs_rx(cfg, y))
    print(f"LTE SRS {cfg.srs_rb} PRB comb 2, 2 RX, B={B}: SNR {float(snr.min()):.2f}-"
          f"{float(snr.max()):.2f} dB at a set {SRS_SNR_DB} dB; srs_rx {ms['srs_rx']:.4f} ms per "
          f"batch on {card}")
    return ms


_LOOP_STAGES = ("pdsch_tx", "pdsch_rx", "pusch_tx", "pusch_rx", "crs_channel_estimate",
                "pdcch_blind_decode", "pucch1_rx", "pucch2_rx")


@contextlib.contextmanager
def _loop_clock(marks: list, stages: dict):
    """While the lte-softmodem loop runs, `marks` gets the host clock at its
    start and at each of its log lines (the RRC line, then one per cycle),
    and `stages` the seconds of each stage of _LOOP_STAGES within the cycles,
    each call ended by a device synchronize."""
    saved = {name: getattr(lte_softmodem, name) for name in ("run_loop", *_LOOP_STAGES)}

    def run_loop(n_cycles=25, seed=0, log=print, device="cuda"):
        def timed_log(line):
            marks.append(time.perf_counter())
            log(line)
        marks.append(time.perf_counter())
        return saved["run_loop"](n_cycles, seed, timed_log, device)

    def timed(name):
        def call(*args, **kw):
            t0 = time.perf_counter()
            out = saved[name](*args, **kw)
            torch.cuda.synchronize()
            if len(marks) > 1:                  # after the RRC line: the cycles
                stages[name] = stages.get(name, 0.0) + time.perf_counter() - t0
            return out
        return call

    lte_softmodem.run_loop = run_loop
    for name in _LOOP_STAGES:
        setattr(lte_softmodem, name, timed(name))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(lte_softmodem, name, fn)


def phase_slice11(dev, gen, card: str) -> None:
    """Phase 11: the LTE control channels at 100 PRB, the nbiotsim case and
    the lte-softmodem-loop case, none launching K1 or K3."""
    t0 = time.perf_counter()
    held = {}
    _reset_counts()
    _lte_downlink_control(dev, gen, card)
    _lte_uplink_control(dev, gen, card)
    c = _counts()
    if any(c.values()):
        raise AssertionError(f"phase 11 control channels launched {c}; they take neither K1 "
                             f"nor K3")
    _sim_cases((("nbiotsim", ()),), held, show_output=True)
    marks, stages = [], {}
    with _loop_clock(marks, stages):
        r = _sim_cases((("lte-softmodem-loop", ()),), held, show_output=True)["lte-softmodem-loop"]
    got = [line for line in r.output.splitlines() if line.startswith("[lte]")]
    record = (pathlib.Path(__file__).resolve().parent / LTE_LOOP_RECORD).read_text().splitlines()
    if got[:LTE_LOOP_CYCLES + 1] != record[9:10 + LTE_LOOP_CYCLES]:
        raise AssertionError(f"lte-softmodem loop lines {got[:LTE_LOOP_CYCLES + 1]} differ from "
                             f"{LTE_LOOP_RECORD}:10-{10 + LTE_LOOP_CYCLES}")
    c = _counts()
    if any(c.values()) or held:
        raise AssertionError(f"phase 11 simulators launched {c}; they take neither K1 nor K3")
    ends = marks[1: LTE_LOOP_CYCLES + 2]          # the RRC line, then each cycle's line
    cycles = [1e3 * (b - a) for a, b in zip(ends, ends[1:])]
    per_cycle = sum(cycles) / len(cycles)
    stage_ms = {k: 1e3 * v / len(cycles) for k, v in sorted(stages.items(), key=lambda kv: -kv[1])}
    print(f"lte-softmodem loop, {LTE_LOOP_CYCLES} cycles: its RRC line and cycle lines equal "
          f"{LTE_LOOP_RECORD}:10-{10 + LTE_LOOP_CYCLES}; RRC connect {1e3 * (marks[1] - marks[0]):.1f} "
          f"ms (7 signalling TBs), {per_cycle:.1f} ms per cycle (host clock; cycles "
          + ", ".join(f"{x:.1f}" for x in cycles) + "); per cycle by stage, each call ended by a "
          f"synchronize: " + ", ".join(f"{k} {v:.1f}" for k, v in stage_ms.items())
          + f", the rest {per_cycle - sum(stage_ms.values()):.1f} ms on {card}")
    print(f"phase 11: LTE control channels, nbiotsim and the lte-softmodem loop without K1 or K3; "
          f"{time.perf_counter() - t0:.1f} s")

# ---- phase 12: the NR runtime loops ----

LOOP_ARGS = ["-u", "3", "-P", "91", "-m", "16", "-s", "20", "-I", "8", "--backend", "kernel"]
LOOP_SLOTS = 40
LOOP_TDD = "7,6,2,4"          # DDDDDDDSUU: OAI's default 5 ms pattern
RA_RECORD = "RA_OTA_r4.txt"                      # the JAX package's recorded runs
CONNECTED_L2_RECORD = "CONNECTED_OTA_L2_r5.txt"
CONNECTED_CYCLES = 8
UE_LOOP_SLOTS = 8
SPLIT_TRIALS = 32
OTA_PORTS = (48601, 48602)    # RA, connected mode
SPLIT_PORTS = (48611, 48612)  # RU, L1


def _record(name: str, prefix: str) -> list:
    text = (pathlib.Path(__file__).resolve().parent / name).read_text()
    return [line for line in text.splitlines() if line.startswith(prefix)]


def _syncs_of_two_slots(args) -> list:
    """A DL and an UL slot of the loop (the TDD pattern D, U; a run before it
    builds the configurations' constants) under
    torch.cuda.set_sync_debug_mode("warn"): each host sync as (where, the
    port's innermost line, count); where is "step" inside a slot's step_fn,
    "retire" where the executor moves a result to the host, "setup" where
    the loop builds its inputs."""
    import traceback
    import warnings
    found = {}

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        stack = traceback.extract_stack()[:-1]
        names = {(pathlib.Path(f.filename).name, f.name) for f in stack}
        where = ("retire" if ("executor.py", "_retire") in names
                 else "step" if ("executor.py", "run") in names else "setup")
        ours = [f for f in stack if "openairinterface5g_tpu_torch" in f.filename]
        site = ours[-1] if ours else [f for f in stack if "warnings" not in f.filename][-1]
        key = (where, f"{pathlib.Path(site.filename).name}:{site.lineno} {site.name}: "
                      f"{(site.line or '').strip()}")
        found[key] = found.get(key, 0) + 1

    two = softmodem.parse_args(args + ["-n", "2", "--tdd", "1,0,1,0,1"])
    softmodem.run(two, log=lambda *a: None)     # each configuration's constants built
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            softmodem.run(two, log=lambda *a: None)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [(w, site, n) for (w, site), n in sorted(found.items())]


def _gnb_loop(held: dict, card: str) -> dict:
    """Phase 12 (a): the nr-softmodem loop at 273 PRB through K3 and K1."""
    lines = []
    with _held_to_plain("phase 12 gNB loop, first UL slot", held, lines, limit=3):
        r = softmodem.run(softmodem.parse_args(LOOP_ARGS + ["-n", "1"]), log=lambda *a: None)
        torch.cuda.synchronize()
    if r["ul_ok"] != [[True] * 3] or held.get("pusch_frontend", (0,))[0] != 3 \
            or held.get("layered_f32", (0,))[0] != 3:
        raise AssertionError(f"phase 12 held slot: TB ok {r['ul_ok']}, held {held}")
    for line in lines:
        print(f"  {line}")
    syncs = _syncs_of_two_slots(LOOP_ARGS)
    print(f"gNB loop, host syncs of a DL and an UL slot (set_sync_debug_mode warn): "
          f"{len(syncs)} sites")
    for where, site, n in syncs:
        print(f"  [{where}] x{n} {site}")
    if any(where == "step" for where, _, _ in syncs):
        raise AssertionError("a slot's step waits for the device: the executor's pipeline "
                             "is gone")
    launches = {"layered_f32": 0, "pusch_frontend": 0}
    for tdd_spec in (None, LOOP_TDD):
        for depth in (2, 1):
            argv = LOOP_ARGS + ["-n", str(LOOP_SLOTS), "--depth", str(depth)] \
                + (["--tdd", tdd_spec] if tdd_spec else [])
            head = []
            _reset_counts()
            r = softmodem.run(softmodem.parse_args(argv), log=head.append)
            torch.cuda.synchronize()
            c = _counts()
            kinds = r["kinds"]
            n_ul, n_dl = kinds.count("U"), kinds.count("D")
            oks = [ok for row in r["ul_ok"] if row is not None for ok in row]
            if not all(oks) or len(oks) != 3 * n_ul:
                raise AssertionError(f"gNB loop {argv}: UL TB ok {r['ul_ok']}")
            if c["pusch_frontend"] != 3 * n_ul or c["layered_f32"] != 3 * n_ul:
                raise AssertionError(f"gNB loop {argv}: launches {c}, want K3 and K1 "
                                     f"{3 * n_ul} each (one per UE and UL slot)")
            for k in launches:
                launches[k] += c[k]
            wall = r["wall"]
            p = r["executor"].percentiles()
            ul_mbps = len(oks) * r["tbs"] / wall / 1e6
            dl_mbps = n_dl * 3 * r["dl_tbs"] / wall / 1e6
            print(f"{head[0]}, depth {depth}: {r['executor'].report()}")
            print(f"  slots/s {LOOP_SLOTS / wall:.1f} [{n_dl} DL / {kinds.count('S')} S / "
                  f"{n_ul} UL], UL TB ok {len(oks)}/{len(oks)}, UL {ul_mbps:.1f} Mb/s, DL TX "
                  f"{dl_mbps:.1f} Mb/s, p50/p90/p99 {p['p50_us']:.0f}/{p['p90_us']:.0f}/"
                  f"{p['p99_us']:.0f} us, mean dispatch "
                  f"{statistics.mean(s.dispatch_us for s in r['executor'].stats):.0f} us; "
                  f"launches {c} on {card}")
    return launches


def _ota_sessions(card: str) -> dict:
    """Phase 12 (b) and (c): RA and connected mode as two OS processes each."""
    launches = {"layered_f32": 0, "pusch_frontend": 0}
    ra = ota_records.session("ra", OTA_PORTS[0], timeout_s=600)
    for role in ("gnb", "ue"):
        if ra[role]["result"] is not True:
            raise AssertionError(f"RA over the air: {role} returned {ra[role]['result']}")
        if ra[role]["lines"] != _record(RA_RECORD, f"[{role}]"):
            raise AssertionError(f"RA over the air: [{role}] lines {ra[role]['lines']} differ "
                                 f"from {RA_RECORD}")
    for role in ("gnb", "ue"):
        for k in launches:
            launches[k] += ra[role]["launches"][k]
    if not (ra["gnb"]["launches"]["pusch_frontend"] and ra["ue"]["launches"]["pusch_frontend"]):
        raise AssertionError(f"RA over the air launched no K3 in an endpoint: "
                             f"{ra['gnb']['launches']}, {ra['ue']['launches']}")
    print(f"RA over the air, two processes over the hub: every [gnb] and [ue] line equals "
          f"{RA_RECORD}'s; session {ra['wall_s']:.1f} s (UE start to last exit), endpoints "
          f"{ra['gnb']['wall_s']:.1f} / {ra['ue']['wall_s']:.1f} s; K3 launches gNB "
          f"{ra['gnb']['launches']['pusch_frontend']}, UE {ra['ue']['launches']['pusch_frontend']}"
          f" on {card}")
    co = ota_records.session("connected", OTA_PORTS[1], CONNECTED_CYCLES, l2=True, timeout_s=900)
    got = [x for x in co["gnb"]["lines"] if x.startswith("[gnb] cyc")]
    want = _record(CONNECTED_L2_RECORD, "[gnb] cyc")
    if len(got) < CONNECTED_CYCLES or got != want[: len(got)]:
        raise AssertionError(f"connected mode --l2: [gnb] lines {got} differ from "
                             f"{CONNECTED_L2_RECORD}'s {want[: len(got)]}")
    st = co["gnb"]["result"]
    if not (st["ul_pkts"] > 0 and st["ul_pkts_intact"] == st["ul_pkts"]
            and co["ue"]["result"].get("dl_pkts", 0) > 0):
        raise AssertionError(f"connected mode --l2: packets {st}, UE {co['ue']['result']}")
    for role in ("gnb", "ue"):
        for k in launches:
            launches[k] += co[role]["launches"][k]
    per = {role: {k: 1e3 * v / CONNECTED_CYCLES for k, v in co[role]["stages_s"].items()}
           for role in ("gnb", "ue")}
    print(f"connected mode --l2, {CONNECTED_CYCLES} cycles, two processes: every [gnb] cycle "
          f"line equals {CONNECTED_L2_RECORD}'s; DL {st['dl_ack']}/{st['dl_tx']} acked, UL "
          f"{st['ul_ok']}/{st['ul_rx']} ok, {st['dl_retx']}+{st['ul_retx']} retx, UL packets "
          f"{st['ul_pkts_intact']}/{st['ul_pkts']} intact; session {co['wall_s']:.1f} s, "
          f"{1e3 * co['gnb']['wall_s'] / CONNECTED_CYCLES:.1f} ms per cycle (gNB process); "
          f"launches gNB {co['gnb']['launches']}, UE {co['ue']['launches']} on {card}")
    for role in ("gnb", "ue"):
        print(f"  {role} ms per cycle by stage (each call ended by a synchronize): "
              + ", ".join(f"{k} {v:.1f}" for k, v in per[role].items()))
    return {"launches": launches, "ra_s": ra["wall_s"], "connected_ms_per_cycle": per}


def _ue_loop(card: str) -> dict:
    """Phase 12 (d): the UE softmodem at its own 48 PRB."""
    def run(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = ue_softmodem.main(argv)
        return rc, buf.getvalue().splitlines()

    _reset_counts()
    rc, got = run(["-n", str(UE_LOOP_SLOTS)])
    torch.cuda.synchronize()
    c = _counts()
    _, cpu = run(["-n", "1", "--device", "cpu"])
    strip = lambda line: line.rsplit(" (", 1)[0]   # noqa: E731  [sync]'s seconds
    if rc != 0 or got[-1] != "UE softmodem OK" or \
            f"[data] {UE_LOOP_SLOTS}/{UE_LOOP_SLOTS} slots" not in got[2]:
        raise AssertionError(f"UE softmodem: rc {rc}, {got}")
    if [strip(got[0]), got[1]] != [strip(cpu[0]), cpu[1]]:
        raise AssertionError(f"UE softmodem: [sync]/[mib] {got[:2]} differ from the CPU's {cpu[:2]}")
    if c["pusch_frontend"] != UE_LOOP_SLOTS:
        raise AssertionError(f"UE softmodem: launches {c}, want K3 once a slot")
    print(f"UE softmodem 48 PRB, {UE_LOOP_SLOTS} slots: {got[0]}; [mib] and [sync] equal the "
          f"CPU run's; {got[2]}; launches {c} on {card}")
    return c


def _split(card: str) -> dict:
    """Phase 12 (e): the IF4p5 RU/L1 split, RU and L1 in two threads."""
    import threading
    lines, res = [], {}
    kw = dict(ru_port=SPLIT_PORTS[0], l1_port=SPLIT_PORTS[1])
    _reset_counts()
    t0 = time.perf_counter()
    t = threading.Thread(target=lambda: res.__setitem__(
        "l1", ru_l1_split.run_l1(SPLIT_TRIALS, log=lines.append, **kw)), daemon=True)
    t.start()
    want = f"0100007F:{SPLIT_PORTS[1]:04X}"       # the L1's socket bound (/proc/net/udp)
    for _ in range(400):
        if any(row.split()[1] == want
               for row in pathlib.Path("/proc/net/udp").read_text().splitlines()[1:]):
            break
        time.sleep(0.05)
    ru_l1_split.run_ru(SPLIT_TRIALS, log=lines.append, **kw)
    t.join(timeout=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = _counts()
    if res.get("l1") is not True or c["pusch_frontend"] == 0:
        raise AssertionError(f"IF4p5 split: L1 returned {res.get('l1')}, launches {c}: {lines}")
    print(f"IF4p5 RU/L1 split, {SPLIT_TRIALS} trials, 106 PRB MCS 9 at 5 dB: "
          + "; ".join(x for x in lines if x.startswith("[l1] UL") or x.startswith("[l1] DL"))
          + f"; {lines[-1]}; {wall:.1f} s; launches {c} on {card}")
    return c


def phase_slice12(dev, gen, card: str) -> dict:
    """Phase 12: the NR runtime loops, (a)-(e)."""
    t0 = time.perf_counter()
    held = {}
    launches = _gnb_loop(held, card)
    ota = _ota_sessions(card)
    for c in (ota["launches"], _ue_loop(card), _split(card)):
        for k in launches:
            launches[k] += c[k]
    print(f"phase 12: the NR runtime loops, launches {launches}; "
          f"{time.perf_counter() - t0:.1f} s")
    return {"launches": launches, "held": {k: held.get(k, (0, 0.0)) for k in launches}}


# ---- phase 13: the rest of the NR stack ----

MSG3_PUSCH = dict(mu=1, n_prb=6, mcs=4, n_layers=1, n_rx=1, rnti=0x4601,
                  decoder_backend="kernel")
MSG3_ITERS = 12
FH_PUSCH = dict(mu=1, n_prb=273, mcs=16, n_layers=2, n_rx=2, decoder_backend="kernel")
FH_ITERS = 8
FH_TIMED = 5              # calls behind each fronthaul stage's MeasGroup figure
FH_MAX_PRB = 64           # PRBs per O-RAN U-plane packet: 5 packets a 273-PRB symbol
IF5_TOL = 2e-3            # JAX's bounds of max|rx| and max|grid| (tests/test_ru_l1_split.py)
ORAN_TOL = 5e-3
PROFILE_DIR = _cuda.BUILD_DIR / "phase13_profile"


@contextlib.contextmanager
def _pinned_urandom():
    """os.urandom as a counter (the RRCSetupRequest's ue_identity draws it),
    so two runs of the call flow send the same PDUs."""
    real, state = os.urandom, {"n": 0}

    def urandom(n):
        state["n"] += 1
        return bytes((state["n"] * 37 + i) & 0xFF for i in range(n))
    os.urandom = urandom
    try:
        yield
    finally:
        os.urandom = real


def _sa_call_flow(dev, meas: profiling.MeasGroup) -> dict:
    """tests/test_e2e_callflow.py's SA call flow with the port's modules:
    PRACH and msg3 (an RRCSetupRequest in a PUSCH TB; K3 and K1 on the card)
    on `dev` with the test's numpy draws, then RRC setup, NAS registration and
    the PDU session through NGAP, security, PDCP (NEA2/NIA2) over RLC UM and
    GTP-U to the UPF stub on the host.  Returns the PRACH detection, the msg3
    TB bits and every PDU the flow sent."""
    rng = np.random.default_rng(0)
    wire = []

    def tap(tag, fn):
        def send(*args):
            wire.append((tag, *args))
            return fn(*args)
        return send

    def fail(what):
        raise AssertionError(f"SA call flow on {dev}: {what}")

    ue_mac = UeMac()
    ra_req = ue_mac.start_ra(slot=0, msg3_payload=b"")
    pcfg = prach.PrachConfig()
    with meas.measure("callflow prach"):
        tx_p = prach.prach_tx(pcfg, torch.tensor([ra_req["preamble_index"]], device=dev))
        shape = tuple(tx_p.shape)
        noise = 0.05 * (rng.normal(size=shape) + 1j * rng.normal(size=shape))
        det = prach.prach_rx(pcfg, (tx_p + torch.as_tensor(noise.astype(np.complex64),
                                                            device=dev))[:, None, :])
        detected, preamble = bool(det["detected"][0]), int(det["preamble"][0])
        delay = int(det["delay"][0])
    if not detected or preamble != ra_req["preamble_index"]:
        fail(f"PRACH detected {detected}, preamble {preamble} of {ra_req['preamble_index']}")
    gnb_mac = MacScheduler(SchedulerConfig())
    gnb_mac.on_rach(RachIndication(sfn=0, slot=1, preambles=((preamble, delay, 0),)))
    msg3 = ue_mac.on_rar(5, {"preamble_index": preamble, "tc_rnti": MSG3_PUSCH["rnti"],
                             "ul_grant": 64})
    if not gnb_mac.ra_queue or msg3 is None or msg3["rnti"] != MSG3_PUSCH["rnti"]:
        fail(f"RAR: msg3 {msg3}")

    rnti = MSG3_PUSCH["rnti"]
    ue_rrc, gnb_rrc = rrc.UeRrc(), rrc.GnbRrc(cell_id=1)
    ul_pdus, dl_pdus = [], []
    ue_rrc.send_ul = tap("rrc ul", lambda srb, pdu: ul_pdus.append(pdu))
    gnb_rrc.send_dl = tap("rrc dl", lambda r, srb, pdu: dl_pdus.append(pdu))
    ue_rrc.connect(nas_pdu=b"")
    rrc_pdu = ul_pdus.pop(0)
    ue_mac.msg3_payload = rrc_pdu
    cfg = pusch.PuschConfig(**MSG3_PUSCH)
    payload = np.frombuffer(len(rrc_pdu).to_bytes(2, "big") + rrc_pdu, np.uint8)
    tb = np.zeros((1, cfg.tbs), np.int8)
    bits = np.unpackbits(payload)[: cfg.tbs]
    tb[0, : len(bits)] = bits
    with meas.measure("callflow msg3 pusch_tx") as box:
        tx_u = pusch.pusch_tx(cfg, torch.as_tensor(tb, device=dev))[0]
        box["sync"] = tx_u
    n = tx_u.shape[-1]
    noise_u = 0.02 * (rng.normal(size=(1, 1, n)) + 1j * rng.normal(size=(1, 1, n)))
    with meas.measure("callflow msg3 pusch_rx") as box:
        out = pusch.pusch_rx(cfg, tx_u + torch.as_tensor(noise_u.astype(np.complex64),
                                                         device=dev), n_iters=MSG3_ITERS)
        box["sync"] = out["tb_bits"]
    tb_bits = out["tb_bits"].cpu().numpy()
    if not bool(out["tb_ok"][0]) or not np.array_equal(tb_bits, tb):
        fail(f"msg3 TB ok {bool(out['tb_ok'][0])}, bits equal {np.array_equal(tb_bits, tb)}")
    rx_bytes = np.packbits(tb_bits[0].astype(np.uint8)).tobytes()
    rx_rrc_pdu = rx_bytes[2: 2 + int.from_bytes(rx_bytes[:2], "big")]
    if rrc.decode_ul(rx_rrc_pdu)[0] != "rrcSetupRequest":
        fail("msg3 does not hold an rrcSetupRequest")

    with meas.measure("callflow rrc setup"):
        gnb_rrc.handle_ul(rnti, rx_rrc_pdu)
        resolved = ue_mac.on_contention_resolution(rnti, rx_rrc_pdu)
        ue_rrc.handle_dl(0, dl_pdus.pop(0))
        gnb_rrc.handle_ul(rnti, ul_pdus.pop(0))
    if not resolved or ue_mac.c_rnti != rnti or gnb_rrc.ue[rnti].state != "CONNECTED":
        fail(f"RRC setup: contention resolved {resolved}, state {gnb_rrc.ue[rnti].state}")

    with meas.measure("callflow nas + ngap"):
        ue_nas, amf_nas = nas.UeNas(), nas.AmfStub()
        dl_nas = []
        gnb_ngap = ngap.GnbNgap(nas_downstream=lambda r, pdu: dl_nas.append(pdu))
        amf_ngap = ngap.AmfNgapStub(nas_handler=amf_nas)
        gnb_ngap.send = tap("ngap ul", amf_ngap.handle)
        amf_ngap.send = tap("ngap dl", gnb_ngap.handle)
        gnb_ngap.ng_setup()
        ran_id = gnb_ngap.initial_ue_message(rnti, ue_nas.start())
        for _ in range(10):
            if not dl_nas:
                break
            pdu = dl_nas.pop(0)
            wire.append(("nas dl", pdu))
            for up in ue_nas.handle(pdu):
                wire.append(("nas ul", up))
                gnb_ngap.uplink_nas(ran_id, up)
    sessions = gnb_ngap.ue[ran_id]["sessions"]
    if ue_nas.state != "SESSION" or ue_nas.ip != "10.0.0.2" or not sessions:
        fail(f"NAS: state {ue_nas.state}, ip {ue_nas.ip}, sessions {sessions}")

    with meas.measure("callflow security + drb"):
        gnb_rrc.start_security(rnti)
        ue_rrc.handle_dl(1, dl_pdus.pop(0))
        gnb_rrc.handle_ul(rnti, ul_pdus.pop(0))
        key = bytes(range(16))
        got_dl = []
        pdcp_gnb = PdcpEntity(PdcpConfig(bearer_id=1, ciphering=True, integrity=True,
                                         key_enc=key, key_int=key, direction=DIR_DL),
                              deliver=lambda p: None)
        pdcp_ue = PdcpEntity(PdcpConfig(bearer_id=1, ciphering=True, integrity=True,
                                        key_enc=key, key_int=key, direction=DIR_UL),
                             deliver=got_dl.append)
        rlc_gnb = RlcUm(deliver=tap("rlc sdu", lambda p: pdcp_ue.pdu_in(p)))
        ip_pkt = b"E\x00\x00\x28" + bytes(36)
        pdcp_pdu = pdcp_gnb.sdu_in(ip_pkt)
        wire.append(("pdcp", pdcp_pdu))
        rlc_gnb.sdu_in(pdcp_pdu)
        while (pdu := rlc_gnb.pdu_out(60)) is not None:
            wire.append(("rlc", pdu))
            rlc_gnb.pdu_in(pdu)
    if not gnb_rrc.ue[rnti].security_on or got_dl != [ip_pkt]:
        fail(f"security {gnb_rrc.ue[rnti].security_on}, DRB delivered {got_dl}")

    with meas.measure("callflow gtp-u"):
        got_upf = []
        upf = gtpu.GtpuEndpoint(deliver=lambda sid, p: got_upf.append(p))
        gnb_up = gtpu.GtpuEndpoint(transport=tap("gtpu", upf.receive))
        gnb_up.add_session(1, local_teid=0x10, remote_teid=sessions[0]["teid"])
        upf.add_session(1, local_teid=sessions[0]["teid"], remote_teid=0x10)
        gnb_up.send(1, ip_pkt)
    if got_upf != [ip_pkt]:
        fail(f"GTP-U delivered {got_upf}")
    return {"prach": (preamble, delay), "tb_bits": tb_bits, "wire": wire}


def _copies(fn) -> list:
    """The host <-> device copies one call of fn makes in the fronthaul
    codecs, as (file, line): the synchronizing operations that
    torch.cuda.set_sync_debug_mode("warn") reports from fronthaul/ (a
    pageable copy synchronizes either way; the codecs have no other sync)."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{pathlib.Path(w.filename).name}:{w.lineno}" for w in caught
            if "synchroniz" in str(w.message) and "fronthaul" in w.filename]


def _fronthaul(name: str, pack, unpack, decode, sent, tol: float, tb, held: dict,
               meas: profiling.MeasGroup, card: str) -> list:
    """One lower split at the main path's configuration: `pack` cuts the
    slot's packets on the card, equal to the CPU packer's on the same values;
    the packets shuffled by a seeded generator, `unpack` rebuilds the slot
    on the card within `tol` of max|sent|; `decode` passes every TB through
    K3 and K1, the first call of each held against its plain version; ms per
    stage (MeasGroup, FH_TIMED calls each, ended by a synchronize), packets,
    bytes and host copies per slot."""
    pkts = pack(sent)
    if pkts != pack(sent.cpu()):
        raise AssertionError(f"{name}: the card's packets differ from the CPU packer's")
    order = np.random.default_rng(SEED).permutation(len(pkts))
    shuffled = [pkts[i] for i in order]
    got = unpack(shuffled)
    err = float((got - sent).abs().max() / sent.abs().max())
    if not err < tol:
        raise AssertionError(f"{name}: rebuilt slot within {err:.3e} of max|sent|, bound {tol}")
    lines = []
    with _held_to_plain(f"phase 13 {name}", held, lines, limit=1):
        out = decode(got)
    _decoded(f"phase 13 {name}", out, tb)
    for _ in range(FH_TIMED):
        with meas.measure(f"{name} pack"):
            pack(sent)
        with meas.measure(f"{name} rebuild") as box:
            box["sync"] = unpack(shuffled)
        with meas.measure(f"{name} decode") as box:
            box["sync"] = decode(got)["tb_ok"]
    copies_pack, copies_unpack = _copies(lambda: pack(sent)), _copies(lambda: unpack(shuffled))
    if len(copies_pack) != 1 or len(copies_unpack) != 1:
        raise AssertionError(f"{name}: host copies per slot {copies_pack} packing, "
                             f"{copies_unpack} rebuilding; want one each")
    print(f"{name} at 273 PRB 2x2 MCS 16, B = 1: {len(pkts)} datagrams, "
          f"{sum(len(p) for p in pkts)} bytes a slot; packets equal the CPU packer's; "
          f"rebuilt from shuffled packets within {err:.3e} of max|sent|; TB decoded through "
          f"K3 and K1; ms pack {1e3 * meas[f'{name} pack'].mean:.3f}, rebuild "
          f"{1e3 * meas[f'{name} rebuild'].mean:.3f}, decode "
          f"{1e3 * meas[f'{name} decode'].mean:.3f} (host clock, mean of {FH_TIMED}); host "
          f"copies a slot (synchronizing ops in fronthaul/): packing {copies_pack}, "
          f"rebuilding {copies_unpack}, on {card}")
    for line in lines:
        print(f"  {line}")
    return pkts


def _profiled_receive(cfg, pkts, n_samp: int, dev, attempts: int = 3) -> None:
    """Phase 13 (d): a profile_to capture of the IF5 receive (rebuild, then
    pusch_rx); its Chrome trace must hold the trace() spans and the rows of
    K3 and K1.  A capture that recorded no row of either is taken again, as
    the profiler can drop a session's kernel rows."""
    for attempt in range(1, attempts + 1):
        with profiling.profile_to(str(PROFILE_DIR)):
            with profiling.trace("phase13 if5 packets_to_slot"):
                wav = if5.packets_to_slot(pkts, cfg.n_rx, n_samp, device=dev)[3]
            with profiling.trace("phase13 pusch_rx"):
                pusch.pusch_rx(cfg, wav[None], n_iters=FH_ITERS)
        events = json.loads((PROFILE_DIR / profiling.TRACE_FILE).read_text())["traceEvents"]
        spans = {e["name"]: e.get("dur", 0.0) for e in events
                 if e.get("name", "").startswith("phase13 ")}
        kernels = [e for e in events if e.get("cat") == "kernel"]
        rows = {k: [e.get("dur", 0.0) for e in kernels if DEVICE_KERNELS[k][0] in e["name"]]
                for k in ("pusch_frontend", "layered_f32")}
        if set(spans) == {"phase13 if5 packets_to_slot", "phase13 pusch_rx"} and \
                all(rows.values()):
            break
        print(f"profile_to attempt {attempt}: spans {sorted(spans)}, {len(kernels)} kernel "
              f"rows, K3/K1 rows { {k: len(v) for k, v in rows.items()} }")
    else:
        raise AssertionError(f"profile_to: no capture of {attempts} held the spans and the "
                             f"rows of K3 and K1")
    print(f"profile_to ({profiling.TRACE_FILE}, attempt {attempt}, {len(events)} events, "
          f"{len(kernels)} kernel rows): spans "
          + ", ".join(f"{k} {v:.1f} us" for k, v in spans.items())
          + "; " + ", ".join(f"{k} {len(v)} row(s) {sum(v):.1f} us" for k, v in rows.items()))


def phase_slice13(dev, gen, card: str) -> dict:
    """Phase 13: (a) the SA call flow, (b) IF5 and (c) the O-RAN U-plane at
    the main path's configuration, (d) a profile_to capture."""
    t0 = time.perf_counter()
    held, meas = {}, profiling.MeasGroup()
    _reset_counts()
    with _pinned_urandom():
        cpu = _sa_call_flow(torch.device("cpu"), profiling.MeasGroup())
    lines, first = [], profiling.MeasGroup()
    with _pinned_urandom(), _held_to_plain("phase 13 call flow msg3", held, lines, limit=1):
        runs = [_sa_call_flow(dev, first)]
    with _pinned_urandom():
        runs.append(_sa_call_flow(dev, meas))          # warm: the stages' figures
    c = _counts()
    if c != {"layered_f32": 2, "pusch_frontend": 2}:
        raise AssertionError(f"SA call flow: launches {c}, want K3 and K1 once a run (msg3)")
    for got in runs:
        if got["prach"] != cpu["prach"] or not np.array_equal(got["tb_bits"], cpu["tb_bits"]) \
                or got["wire"] != cpu["wire"]:
            raise AssertionError("SA call flow: the card's detection, msg3 bits or PDUs "
                                 "differ from the CPU run's")
    tags = sorted({w[0] for w in got["wire"]})
    print(f"SA call flow, twice: PRACH preamble and delay {got['prach']}, msg3 TB "
          f"({pusch.PuschConfig(**MSG3_PUSCH).tbs} bits) through K3 and K1; "
          f"{len(got['wire'])} PDUs ({', '.join(tags)}) equal the CPU run's; launches {c} "
          f"on {card}; the first run's stages (first calls on the card):")
    for line in first.report().splitlines():
        print(f"  {line}")
    for line in lines:
        print(f"  {line}")

    cfg = pusch.PuschConfig(**FH_PUSCH)
    tb = torch.randint(0, 2, (1, cfg.tbs), generator=gen, device=dev, dtype=torch.int8)
    rx = _bench_channel(pusch.pusch_tx(cfg, tb)[0], gen)
    n_samp = rx.shape[-1]
    pkts = _fronthaul(
        "IF5", lambda x: if5.slot_to_packets(if5.UL_TD, 3, 7, x),
        lambda p: if5.packets_to_slot(p, cfg.n_rx, n_samp, device=dev)[3],
        lambda w: pusch.pusch_rx(cfg, w[None], n_iters=FH_ITERS), rx[0], IF5_TOL, tb, held,
        meas, card)
    grid = extract_from_grid(cfg.fp, ofdm_demodulate(cfg.fp, rx, 0))[0]
    _fronthaul(
        "O-RAN U-plane", lambda g: oran.grid_to_uplane(g, slot=7, max_prb_per_pkt=FH_MAX_PRB),
        lambda p: oran.uplane_to_grid(p, cfg.n_rx, grid.shape[1], grid.shape[2], device=dev),
        lambda g: pusch.pusch_rx_grid(cfg, g[None], n_iters=FH_ITERS), grid, ORAN_TOL, tb,
        held, meas, card)
    _profiled_receive(cfg, pkts, n_samp, dev)
    launches = _counts()
    if sorted(held) != sorted(launches) or any(held[k][0] != 3 for k in held):
        raise AssertionError(f"phase 13: calls held {held}, want 3 of each kernel")
    print("phase 13 stages (utils/profiling.py MeasGroup, host clock, each call ended by a "
          "synchronize):")
    for line in meas.report().splitlines():
        print(f"  {line}")
    print(f"phase 13: the SA call flow, IF5 and O-RAN 7.2 through K3 and K1, launches "
          f"{launches}; {time.perf_counter() - t0:.1f} s on {card}")
    return {"launches": launches, "held": held}


# ---- phase 14: multi-device (parallel/) ----

PHASE14_MAX_WORLD = 8
PHASE14_KERNELS = ("pusch_frontend", "layered_f32", "flooding_f32")
# the launches of each dry-run phase on a rank: dp's two HARQ rounds through
# pusch_rx (K3, K1 layered); sp's one decode (K1 flooding; none outside its
# mesh); dp x cb's frontend and decode
PHASE14_LAUNCHES = {"dp": {"pusch_frontend": 2, "layered_f32": 2, "flooding_f32": 0},
                    "sp": {"pusch_frontend": 0, "layered_f32": 0, "flooding_f32": 1},
                    "dpcb": {"pusch_frontend": 1, "layered_f32": 0, "flooding_f32": 1}}


def _phase14_rank() -> dict:
    """One rank of phase 14 (in its own process, its card current, NCCL up):
    the dry run's three phases at 273 PRB, the counts set to 0 before each
    and read after it, the rank's first call of each kernel held against
    its plain version; raises where a TB, a code block or a count is wrong."""
    held, lines, launches, seconds = {}, [], {}, {}
    with _held_to_plain("phase 14", held, lines, limit=1, kernels=PHASE14_KERNELS):
        for name in dryrun.PHASES:
            _reset_counts()
            run = dryrun.run_phase(name)
            launches[name] = dict(_counts(), flooding_f32=ldpc_decoder.launches["flooding_f32"])
            seconds[name], out = run["seconds"], run["out"]
            want = dict(PHASE14_LAUNCHES[name], **({"flooding_f32": 0} if out is None else {}))
            if launches[name] != want:
                raise AssertionError(f"phase 14 {name}: launches {launches[name]}, want {want}")
            if name == "dp" and not (out["n_ok"] == torch.distributed.get_world_size()
                                     and torch.equal(out["tb_bits"], out["tb_sent"])):
                raise AssertionError(f"phase 14 dp: {out['line']}, or the TB differs from the sent")
            if name == "sp" and out is not None and not (
                    bool(out["tb_ok"].all()) and torch.equal(out["tb_bits"], out["tb_sent"])):
                raise AssertionError(f"phase 14 sp: {out['line']}, or a TB differs from the sent")
            if name == "dpcb" and not bool(out["cb_ok"].all()):
                raise AssertionError(f"phase 14 dp x cb: {out['line']}")
    if sorted(held) != sorted(PHASE14_KERNELS) or any(c != 1 for c, _ in held.values()):
        raise AssertionError(f"phase 14: calls held {held}, want the first of each kernel")
    dev = torch.cuda.current_device()
    return {"card": f"cuda:{dev} {torch.cuda.get_device_name(dev)}", "launches": launches,
            "seconds": seconds, "held": held, "lines": lines}


def phase_slice14(card: str) -> dict:
    """Phase 14: parallel/dryrun.py's dry run on every card (at most
    PHASE14_MAX_WORLD), one rank each over NCCL (launch.spawn; the kernels
    were built by phase 2, the ranks only load them)."""
    t0 = time.perf_counter()
    world = min(torch.cuda.device_count(), PHASE14_MAX_WORLD)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=index,name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()
    ranks = launch.spawn(_phase14_rank, world, "cuda")
    launches = {k: sum(sum(r["launches"][p][k] for p in dryrun.PHASES) for r in ranks)
                for k in PHASE14_KERNELS}
    held = {k: (sum(r["held"][k][0] for r in ranks), max(r["held"][k][1] for r in ranks))
            for k in PHASE14_KERNELS}
    print(f"phase 14: {world} rank(s) over NCCL (rank 0 printed the dry run's lines); the "
          f"cards (nvidia-smi): {'; '.join(smi)}")
    for rank, r in enumerate(ranks):
        secs = ", ".join(f"{p} {r['seconds'][p]:.2f} s" for p in dryrun.PHASES)
        print(f"  rank {rank} on {r['card']}: {secs} (host clock, the card synchronized) on "
              f"{card}; launches {r['launches']}")
        for line in r["lines"]:
            print(f"    {line}")
    print(f"phase 14: the dp, sp and dp x cb dry run at 273 PRB through K3, K1 layered and K1 "
          f"flooding on every rank, launches {launches}; {time.perf_counter() - t0:.1f} s "
          f"on {card}")
    return {"launches": launches, "held": held}


def _entry(name, launches, err, ms, plain_ms, bound, device_ms, host_us, library_ms=None,
           **extra):
    src, replaces = KERNEL_SOURCES[name]
    return {"name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": library_ms,
            "device_ms": device_ms, "host_us": host_us, **extra}


def main() -> None:
    smi_line = phase_device()
    torch.manual_seed(SEED)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    phase_build()
    phase_frontend(dev, gen)
    main_path = phase_main_path(dev, gen, smi_line)
    decoder = phase_decoder(dev, gen)
    probes = phase_probes(dev, gen)
    sims = phase_simulators()
    slice8 = phase_slice8(dev, gen, smi_line, main_path["slots_per_s"])
    slice9 = phase_slice9(dev, gen, smi_line, main_path["slots_per_s"])
    slice10 = phase_slice10(dev, gen, smi_line)
    phase_slice11(dev, gen, smi_line)
    slice12 = phase_slice12(dev, gen, smi_line)
    slice13 = phase_slice13(dev, gen, smi_line)
    slice14 = phase_slice14(smi_line)

    kernels = []
    for name in ("layered_f32", "pusch_frontend"):   # slice 1: the main path's own
        ms, plain_ms = main_path["times"][name]
        kernels.append(_entry(name, main_path["launches"][name], main_path["errs"][name],
                              ms, plain_ms, main_path["bounds"][name],
                              main_path["device"][name], main_path["host"][name],
                              launches_simulators=sims["launches"][name],
                              held_simulators=sims["held"][name][0],
                              max_abs_err_simulators=sims["held"][name][1],
                              launches_phase8=slice8["launches"][name],
                              held_phase8=slice8["held"][name][0],
                              max_abs_err_phase8=slice8["held"][name][1],
                              launches_phase9=slice9["launches"][name],
                              held_phase9=slice9["held"][name][0],
                              max_abs_err_phase9=slice9["held"][name][1],
                              launches_phase10=slice10["launches"][name],
                              held_phase10=slice10["held"][name][0],
                              max_abs_err_phase10=slice10["held"][name][1],
                              launches_phase12=slice12["launches"][name],
                              held_phase12=slice12["held"][name][0],
                              max_abs_err_phase12=slice12["held"][name][1],
                              launches_phase13=slice13["launches"][name],
                              held_phase13=slice13["held"][name][0],
                              max_abs_err_phase13=slice13["held"][name][1],
                              launches_phase14=slice14["launches"][name],
                              held_phase14=slice14["held"][name][0],
                              max_abs_err_phase14=slice14["held"][name][1],
                              **({"split": main_path["split"]} if name == "layered_f32" else {})))
    for name, row in decoder["rows"].items():
        if name == "layered_f32":
            continue
        r1, r0 = row[1], row[0]
        p14 = ({} if name not in slice14["launches"] else dict(
            launches_phase14=slice14["launches"][name], held_phase14=slice14["held"][name][0],
            max_abs_err_phase14=slice14["held"][name][1]))
        kernels.append(_entry(name, decoder["launches"][name], r1["err"], r1["ms"],
                              r1["plain_ms"], r1["bound"], r1["device_ms"], r1["host_us"],
                              mean_iters=r1["mean_iters"], **p14,
                              max_abs_err_check_every_0=r0["err"],
                              ms_check_every_0=r0["ms"],
                              plain_ms_check_every_0=r0["plain_ms"],
                              bound_ms_check_every_0=r0["bound"][0],
                              device_ms_check_every_0=r0["device_ms"],
                              host_us_check_every_0=r0["host_us"]))
    for name, r in probes["probes"].items():
        kernels.append(_entry(name, probes["launches"][name], r["err"], r["ms"],
                              r["plain_ms"], r["bound"], r["device_ms"], r["host_us"],
                              r["library_ms"], graph_device_ms=r["graph_device_ms"],
                              library_host_us=r["library_host_us"],
                              library_device_ms=r["library_device_ms"],
                              ratio_to_library=r["ratio_to_library"],
                              **({"host_us_parts": probes["route_parts"]} if name == "tiny" else {})))
    print(f"card: {smi_line}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
