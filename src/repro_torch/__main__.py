"""``python -m repro_torch``: the YOLOv3 NVDLA/SoC case study."""
import sys

from repro_torch.case_study import main

if __name__ == "__main__":
    sys.exit(main())
