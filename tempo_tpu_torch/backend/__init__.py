from .local import LocalBackend
from .raw import BackendError, DoesNotExist, RawBackend
from .types import (NAME_META, NAME_SEARCH, NAME_SEARCH_HEADER, BlockMeta,
                    new_block_id)

__all__ = ["BlockMeta", "NAME_META", "NAME_SEARCH", "NAME_SEARCH_HEADER",
           "new_block_id", "RawBackend", "BackendError", "DoesNotExist",
           "LocalBackend"]
