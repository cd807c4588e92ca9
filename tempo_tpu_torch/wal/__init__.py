from .wal import (WAL, AppendBlock, parse_wal_filename, resolve_wal_encoding,
                  wal_filename)

__all__ = ["WAL", "AppendBlock", "parse_wal_filename", "wal_filename",
           "resolve_wal_encoding"]
