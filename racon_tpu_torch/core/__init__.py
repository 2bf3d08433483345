from .store import SequenceStore, SequenceStoreBuilder  # noqa: F401
from .overlaps import OverlapTable  # noqa: F401
