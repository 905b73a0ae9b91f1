from repro_torch.data.synthetic import make_covertype_like  # noqa: F401
