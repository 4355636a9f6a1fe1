"""Models of the port. ``build_model`` and friends resolve lazily: the
kernel wrappers import ``models.attention`` for their plain versions,
and ``models.model`` imports the wrappers."""

_EXPORTS = ("CachePlan", "Model", "build_model", "decode_cache_plan")


def __getattr__(name):
    if name in _EXPORTS:
        from repro_torch.models import model
        return getattr(model, name)
    raise AttributeError(name)
