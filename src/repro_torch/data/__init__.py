from repro_torch.data.synthetic import SyntheticStream, make_batch  # noqa: F401
