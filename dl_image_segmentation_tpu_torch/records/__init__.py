"""TFRecord shards of chip pairs: CRC32C, the Example codec, framing,
the parsers of the storage modes and the MP and MT shard writers
(copies of the JAX package's ``records/``, through the storage layer)."""

from .parsers import (parse_8bit_array_proto, parse_encoded_gdal_proto_eager,
                      parse_encoded_gdal_proto_wrapped,
                      parse_encoded_rgb_img_proto,
                      parse_higher_dtype_array_proto)
from .tfrecord import (TFRecordWriter, list_shards, read_records,
                       shard_filename)
from .writers import process_dataset_mp, process_dataset_multithreaded

__all__ = ["TFRecordWriter", "list_shards", "parse_8bit_array_proto",
           "parse_encoded_gdal_proto_eager",
           "parse_encoded_gdal_proto_wrapped", "parse_encoded_rgb_img_proto",
           "parse_higher_dtype_array_proto", "process_dataset_mp",
           "process_dataset_multithreaded", "read_records", "shard_filename"]
