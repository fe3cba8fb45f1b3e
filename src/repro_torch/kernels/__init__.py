"""Hand-written Hopper kernels of the port (CUDA C++ under ``csrc/``),
their wrappers and plain PyTorch versions.  Nothing is built at import."""


def launch_counters() -> dict:
    """Every kernel wrapper's launch counter: ``{key: (wrapper, attr)}``,
    the key ``name`` for its ``launches`` and ``name.route`` for each
    ``launches_<route>``."""
    from repro_torch.kernels.flash_attention import flash_attend
    from repro_torch.kernels.ssd_scan import ssd_chunked
    out = {}
    for name, fn in (("flash_attention", flash_attend),
                     ("ssd_scan", ssd_chunked)):
        for attr in sorted(vars(fn)):
            if attr == "launches":
                out[name] = (fn, attr)
            elif attr.startswith("launches_"):
                out[f"{name}.{attr[len('launches_'):]}"] = (fn, attr)
    return out
