from .serving import Request, ServingEngine  # noqa: F401
