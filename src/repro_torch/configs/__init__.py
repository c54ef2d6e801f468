from .base import ADMMConfig
