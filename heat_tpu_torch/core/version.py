"""Version information (counterpart of ``heat_tpu/core/version.py``)."""
major: int = 1
minor: int = 1
micro: int = 1
extension: str = "torch"

__version__ = f"{major}.{minor}.{micro}-{extension}"
