"""Key/value stores of the PyTorch port: the local ``kvstore`` types and
the ``rpc`` transport; the parameter server itself comes with the
scale-out slice."""

from .kvstore import KVStore, KVStoreDevice, KVStoreLocal, create

__all__ = ["KVStore", "KVStoreLocal", "KVStoreDevice", "create"]
