"""ABCI: the application-blockchain interface (reference abci/)."""

from . import types
from .application import Application, BaseApplication
from .client import Client, LocalClient

__all__ = ["types", "Application", "BaseApplication", "Client", "LocalClient"]
