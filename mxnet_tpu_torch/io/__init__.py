"""``mx.io``: data iterators."""
from .io import (CSVIter, DataBatch, DataDesc, DataIter, DeviceStager,
                 ImageRecordIter, LibSVMIter, MNISTIter, NDArrayIter,
                 PrefetchingIter, ResizeIter, TokenRecordIter,
                 write_token_shard)

__all__ = ["DataBatch", "DataDesc", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "MNISTIter", "CSVIter", "LibSVMIter",
           "ImageRecordIter", "TokenRecordIter", "DeviceStager",
           "write_token_shard"]
