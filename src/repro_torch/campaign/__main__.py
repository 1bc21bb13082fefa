"""``python -m repro_torch.campaign``: see ``repro_torch.campaign.cli``."""
from repro_torch.campaign.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
