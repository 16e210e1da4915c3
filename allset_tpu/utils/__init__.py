import importlib


def require(module: str, purpose: str):
    """Import an optional dependency, or fail saying what needed it."""
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(
            f"{purpose} needs the optional package {module.split('.')[0]!r}, "
            f"which is not installed"
        ) from e
