from .config import ModelConfig
from .transformer import Model, build_model
