"""The port's kernels' wrappers, and the user-facing
``DeepSpeedTransformerConfig`` / ``DeepSpeedTransformerLayer`` (imported
when first asked for, so that importing one kernel's module loads no
model code)."""

_LAYER = ("DeepSpeedTransformerConfig", "DeepSpeedTransformerLayer")


def __getattr__(name):
    if name in _LAYER:
        from . import transformer

        return getattr(transformer, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
