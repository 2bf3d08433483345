from .sniff import (  # noqa: F401
    open_sequence_parser,
    open_overlap_parser,
    SEQUENCE_EXTENSIONS,
    OVERLAP_EXTENSIONS,
)
