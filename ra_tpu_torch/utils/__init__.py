"""Host utilities of the port."""


def host_envelope() -> dict:
    """Host resource envelope for soak and chip-run tails: the fd cap and
    the core count (both surfaced as cross-host drift in the reference's
    captures), and the torch build and card a number was taken on (the
    reference stamps its JAX version and backend there)."""
    import os
    env: dict = {"cpu_count": os.cpu_count()}
    try:
        import resource
        env["rlimit_nofile"] = resource.getrlimit(resource.RLIMIT_NOFILE)[0]
    except (ImportError, OSError, ValueError):
        pass
    import torch
    env["torch_version"] = torch.__version__
    env["cuda_version"] = torch.version.cuda
    env["device_name"] = torch.cuda.get_device_name(0) \
        if torch.cuda.is_available() else "cpu"
    return env
