"""The paper's primary contribution: NVDLA integrated into an SoC with a
configurable shared memory hierarchy — the PyTorch port of ``repro.core``
on the case study's path.

Subsystems:
* ``yolov3``       — the benchmark network descriptor (66 GOP / frame);
* ``runtime``      — command-stream compiler (accel/CPU split, tiling);
* ``quant``        — int8 calibration for the accelerated path;
* ``accelerator``  — NVDLA nv_large timing model behind the shared LLC;
* ``cache``        — exact set-associative LLC simulator (runtime-config)
                     with the lane-batched segment engine;
* ``traces``       — compressed (base, stride, count) DBB trace
                     generation from the command stream;
* ``sweep``        — lane-batched multi-geometry LLC sweeps;
* ``dram``         — the DRAM configuration;
* ``interference`` — BwWrite co-runner perturbations;
* ``soc``          — composition + the paper's three experiments.
"""
from repro_torch.core.soc import (  # noqa: F401
    SoCConfig,
    interference_sweep,
    llc_sweep,
    platform_table,
    run_yolov3,
)
