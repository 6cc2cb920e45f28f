"""IO of the port: the columnar file formats (``file_io``), expression
deserialization (``serialization``; protobuf only for its proto entry
points) and the external merge sort (``external``)."""
from .file_io import load, read_table, save, write_table
from .serialization import (SerializationError, build_aggregation,
                            build_expression, build_expression_from_json,
                            build_expression_from_proto,
                            build_expression_from_proto_bytes,
                            build_sort_order, register_function)
