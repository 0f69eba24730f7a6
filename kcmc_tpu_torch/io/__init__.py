"""Stack I/O of the port (a copy of kcmc_tpu/io without the object
store): TIFF read/write (native threaded decoder), pluggable streaming
ingest (Zarr/HDF5/npy/raw/array via one reader protocol), chunked
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
from kcmc_tpu_torch.io.reader import ChunkedStackLoader
from kcmc_tpu_torch.io.tiff import TiffStack, read_stack, write_stack

__all__ = [
    "ArrayStack",
    "AsyncBatchWriter",
    "ChunkedStackLoader",
    "DecodePool",
    "HDF5Stack",
    "NpyStack",
    "RawStack",
    "TiffStack",
    "ZarrStack",
    "feeder",
    "open_stack",
    "read_stack",
    "write_stack",
]
