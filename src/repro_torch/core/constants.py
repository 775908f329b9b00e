# Port of repro/core/constants.py: the same numpy code, imports rewritten to repro_torch.
"""Hardware constants for the TPU v5e target and the heterogeneous fleet model.

The paper (SynergAI) characterizes a heterogeneous CPU fleet (x86 Xeon VM,
Jetson AGX, Jetson NX) with per-board operating modes (Table 2).  We adapt the
same structure to a TPU v5e fleet: worker pools are TPU slices of different
sizes, and operating modes scale (clock, #chips online, power budget) exactly
as the paper's Table 2 scales (CPU MHz, #online CPUs, power budget).

All roofline numbers are per-chip peak values for TPU v5e (the dry-run /
roofline target given in the assignment).
"""

from __future__ import annotations

import dataclasses

# --- TPU v5e per-chip peaks (assignment-given) -------------------------------
PEAK_FLOPS_BF16 = 197e12        # FLOP/s per chip, bf16 on the MXU
PEAK_FLOPS_INT8 = 394e12        # FLOP/s per chip, int8 (2x bf16)
HBM_BW = 819e9                  # bytes/s per chip
ICI_BW = 50e9                   # bytes/s per ICI link
ICI_LINKS = 4                   # links per chip in a 2D torus (v5e)
HBM_BYTES = 16 * 1024**3        # 16 GiB HBM per chip
VMEM_BYTES = 128 * 1024**2      # ~128 MiB VMEM per chip (v5e, approximate)
MXU_DIM = 128                   # systolic array tile edge
CHIP_TDP_W = 200.0              # approximate per-chip board power at full clock

# Host-side constants used by the pre-processing time model (tokenization,
# request unpacking, weights paging on cold start).
HOST_TOKENIZE_S_PER_MB = 0.004  # host pre-processing seconds per MB of request
MODEL_LOAD_GBPS = 32e9          # weight-load bandwidth (DC network / PCIe-ish)
ENGINE_INIT_S = 0.8             # fixed engine/backend initialization cost

# Static share of CHIP_TDP_W a powered-on chip draws at zero load (the
# constant term in OperatingMode.power_w's static + dynamic-c^2 split).
# This is the idle/static power floor: it is what a slice burns while
# waiting, what WAN-transfer seconds are billed at (the chips idle while
# the wire moves bytes), and why "race to idle" — finish fast at a high
# clock, then idle — beats running slow (paper Fig. 12).
IDLE_POWER_FRACTION = 0.45


@dataclasses.dataclass(frozen=True)
class OperatingMode:
    """A slice operating point, mirroring the paper's Table 2 rows.

    clock_scale multiplies the chip's peak FLOP/s *and* HBM bandwidth (DVFS
    scales the whole SoC); chips_online restricts how many chips of the slice
    participate; power_budget_w caps the total slice draw.  Following the
    paper's Key Outcome 4 ("power budget influences performance indirectly
    based on the frequency and modes it enables"), the budget caps *energy*
    accounting, not the clock.
    """

    name: str
    clock_scale: float
    chips_online: int
    power_budget_w: float

    def effective_clock(self) -> float:
        return self.clock_scale

    def power_w(self) -> float:
        # Total slice draw: static floor + dynamic ~c^2 (boards draw a
        # large static fraction, which is why "race to idle" at high clock
        # saves energy per job — the effect behind the paper's Fig. 12).
        c = self.effective_clock()
        draw = CHIP_TDP_W * (IDLE_POWER_FRACTION + 0.55 * c * c) \
            * self.chips_online
        return min(draw, self.power_budget_w)

    def idle_power_w(self) -> float:
        """Static draw of the slice at this operating point: the powered-on
        chips' idle floor, with no dynamic term.  Capped by the same power
        budget as the active draw (a budget that clamps active draw clamps
        the floor too, trivially)."""
        draw = CHIP_TDP_W * IDLE_POWER_FRACTION * self.chips_online
        return min(draw, self.power_budget_w)


# Mirrors the paper's Table 2 row-for-row (clock ratios from the MHz values;
# power budgets scaled to TPU wattage): "edge-large" has the AGX's 6 modes,
# "edge-small" the NX's 9 modes.  The cloud pod runs one full-clock mode,
# like the x86 VM (whose tunable was thread count == our chips-per-replica,
# explored by the Performance-aware Configuration Generator instead).
AGX_LIKE_MODES = [
    OperatingMode("mode1", 0.53, 8, 600.0),   # 1200 MHz, 8 cores, 30 W
    OperatingMode("mode2", 0.64, 6, 600.0),   # 1450 MHz, 6
    OperatingMode("mode3", 0.79, 4, 600.0),   # 1780 MHz, 4
    OperatingMode("mode4", 0.93, 2, 600.0),   # 2100 MHz, 2
    OperatingMode("mode5", 0.97, 4, 300.0),   # 2188 MHz, 4, 15 W
    OperatingMode("mode6", 1.00, 8, 800.0),   # 2266 MHz, 8, MAXN (~2x the 30W-class draw, as on real boards)
]

NX_LIKE_MODES = [
    OperatingMode("mode1", 0.63, 4, 200.0),   # 1200 MHz, 4, 10 W
    OperatingMode("mode2", 0.74, 4, 300.0),   # 1400 MHz, 4, 15 W
    OperatingMode("mode3", 0.74, 4, 400.0),   # 1400 MHz, 4, 20 W
    OperatingMode("mode4", 0.74, 6, 300.0),   # 1400 MHz, 6, 15 W
    OperatingMode("mode5", 0.74, 6, 400.0),   # 1400 MHz, 6, 20 W
    OperatingMode("mode6", 0.79, 2, 200.0),   # 1500 MHz, 2, 10 W
    OperatingMode("mode7", 1.00, 2, 300.0),   # 1900 MHz, 2, 15 W
    OperatingMode("mode8", 1.00, 2, 400.0),   # 1900 MHz, 2, 20 W
    OperatingMode("mode9", 1.00, 4, 200.0),   # 1900 MHz, 4, 10 W
]

CLOUD_MODES = [OperatingMode("full", 1.00, 16, 16 * 400.0)]

# Cloud chips are a beefier generation (v5p-class), mirroring the paper's
# x86 server being the most powerful node in the testbed.
V5P_FLOPS_BF16 = 459e12
V5P_HBM_BW = 2765e9
V5P_HBM_BYTES = 95 * 1024**3

# Inter-region WAN link (hierarchical scheduling, repro/core/hierarchy.py):
# cross-region placements ship the request input — and, for disaggregated
# jobs whose decode leg lands in another region, the KV handoff — over a
# metro/long-haul link that is an order of magnitude thinner and ~10x
# higher-latency than the in-region disaggregation fabric
# (serving_bridge.DISAGG_XFER_*).
REGION_XFER_GBPS = 1e9         # bytes/s
REGION_XFER_LAT_S = 0.05       # one-way inter-region latency
TOKEN_BYTES = 4                # wire bytes per shipped prompt token id
