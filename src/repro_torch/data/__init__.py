from .corpus import AuthTraceConfig, generate_authtrace  # noqa: F401
from .tokenizer import HashTokenizer  # noqa: F401
