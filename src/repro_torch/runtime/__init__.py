from .serving import Request, ServingEngine  # noqa: F401
from .straggler import StragglerPolicy  # noqa: F401
from .train_loop import TrainLoop, TrainLoopConfig  # noqa: F401
