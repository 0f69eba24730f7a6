"""Stack I/O of the port (a copy of kcmc_tpu/io): TIFF read/write
(native threaded decoder), pluggable streaming ingest (Zarr/HDF5/npy/
raw/array via one reader protocol), object-store ingest and egress
(the emu:// emulator, hedged reads, durable manifests), chunked
prefetch loading, the sharded decode-pool feeder and the background
writer. Imports numpy only, so decode-pool workers stay light."""

from kcmc_tpu_torch.io import feeder
from kcmc_tpu_torch.io.async_writer import AsyncBatchWriter
from kcmc_tpu_torch.io.feeder import DecodePool
from kcmc_tpu_torch.io.formats import (
    ArrayStack,
    HDF5Stack,
    NpyStack,
    RawStack,
    ZarrStack,
    open_stack,
)
from kcmc_tpu_torch.io.objectstore import (
    EmulatedObjectStore,
    ObjectStack,
    ObjectStoreWriter,
    put_stack,
)
from kcmc_tpu_torch.io.reader import ChunkedStackLoader
from kcmc_tpu_torch.io.tiff import TiffStack, read_stack, write_stack

__all__ = [
    "ArrayStack",
    "AsyncBatchWriter",
    "ChunkedStackLoader",
    "DecodePool",
    "EmulatedObjectStore",
    "HDF5Stack",
    "NpyStack",
    "ObjectStack",
    "ObjectStoreWriter",
    "RawStack",
    "TiffStack",
    "ZarrStack",
    "feeder",
    "open_stack",
    "put_stack",
    "read_stack",
    "write_stack",
]
