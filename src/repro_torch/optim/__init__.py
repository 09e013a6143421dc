from .adamw import AdamWConfig, adamw_init, adamw_update  # noqa: F401
from .schedule import cosine_schedule  # noqa: F401
from .compress import compress_grads, decompress_grads  # noqa: F401
