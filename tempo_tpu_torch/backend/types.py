"""Block metadata and object naming (the reference's ``backend/types.py``
without compacted metas and the tenant index). ``meta.json`` uses the
same JSON fields, so the port reads the reference's blocks and the
reference reads the port's: the search container's fields and the trace
objects' (data, index and bloom geometry) alike."""

from __future__ import annotations

import json
import uuid
from dataclasses import asdict, dataclass

VERSION_VT1 = "vT1"

NAME_META = "meta.json"
NAME_DATA = "data"
NAME_INDEX = "index"
NAME_SEARCH = "search"
NAME_SEARCH_HEADER = "search-header.json"


def bloom_name(shard: int) -> str:
    return f"bloom-{shard}"


def new_block_id() -> str:
    return str(uuid.uuid4())


@dataclass
class BlockMeta:
    version: str = VERSION_VT1
    block_id: str = ""
    tenant_id: str = ""
    start_time: int = 0  # unix seconds, min over objects
    end_time: int = 0    # unix seconds, max over objects
    total_objects: int = 0
    size: int = 0
    compaction_level: int = 0
    encoding: str = "zstd"
    index_page_size: int = 0
    total_records: int = 0
    data_encoding: str = "v2"
    bloom_shard_count: int = 0
    bloom_shard_size_bytes: int = 0
    min_id: str = ""
    max_id: str = ""
    search_pages: int = 0
    search_size: int = 0
    search_entries_per_page: int = 0
    search_kv_per_entry: int = 0

    def __post_init__(self):
        if not self.block_id:
            self.block_id = new_block_id()

    def to_json(self) -> bytes:
        return json.dumps(asdict(self), sort_keys=True).encode()

    @classmethod
    def from_json(cls, data: bytes) -> "BlockMeta":
        d = json.loads(data)
        return cls(**{k: v for k, v in d.items()
                      if k in cls.__dataclass_fields__})

    def extend_range(self, start: int, end: int) -> None:
        if start:
            self.start_time = min(self.start_time or start, start)
        if end:
            self.end_time = max(self.end_time, end)
