"""The paper's primary contribution: NVDLA integrated into an SoC with a
configurable shared memory hierarchy under FAME-1 token simulation — the
PyTorch port of ``repro.core``'s main path.

Subsystems:
* ``yolov3``       — the benchmark network descriptor (66 GOP / frame);
* ``runtime``      — command-stream compiler (accel/CPU split, tiling);
* ``quant``        — int8 calibration for the accelerated path;
* ``accelerator``  — NVDLA nv_large timing model behind the shared LLC;
* ``cache``        — exact set-associative LLC simulator (runtime-config)
                     with the lane-batched segment engine (way-masked,
                     miss-bit collecting lanes);
* ``traces``       — compressed (base, stride, count) DBB trace
                     generation from the command stream;
* ``sweep``        — lane-batched multi-geometry LLC sweeps, the
                     interference and way-partition lanes, per-request
                     latencies and the Fig. 5/6 sweeps;
* ``dram``         — bank/row DRAM timing model;
* ``fame1``        — token-based target-clock decoupling combinators
                     (chunked early-exit host scheduler);
* ``socsim``       — the FAME-1 LLC -> DRAM pipeline (paper Fig. 2) and
                     its segment-native totals;
* ``interference`` — BwWrite co-runner perturbations;
* ``npu``          — second backend: weight-stationary systolic GEMM
                     array compiling model-zoo workloads to the same
                     DBB segments;
* ``noc``          — cycle-token NoC switch (per-cycle reference and
                     FAME-1 token-bundle implementation, bit-identical);
* ``farm``         — N SoC nodes behind one switch and one shared
                     LLC/DRAM: per-request victim latency, interconnect
                     plus memory (the Fig. 6 tail);
* ``soc``          — composition + the paper's three experiments.
"""
from repro_torch.core.soc import (  # noqa: F401
    SoCConfig,
    interference_sweep,
    llc_sweep,
    platform_table,
    run_yolov3,
)
