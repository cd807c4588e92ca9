from .local import LocalBackend
from .raw import BackendError, DoesNotExist, RawBackend
from .types import (NAME_DATA, NAME_INDEX, NAME_META, NAME_SEARCH,
                    NAME_SEARCH_HEADER, BlockMeta, bloom_name, new_block_id)

__all__ = ["BlockMeta", "NAME_META", "NAME_DATA", "NAME_INDEX",
           "NAME_SEARCH", "NAME_SEARCH_HEADER", "bloom_name",
           "new_block_id", "RawBackend", "BackendError", "DoesNotExist",
           "LocalBackend"]
