"""Error types. CLI-facing messages mirror the reference's exact strings
(reference: src/polisher.cpp:62-132, src/main.cpp:146-150) so that scripted
users of racon see identical diagnostics."""


class RaconError(RuntimeError):
    """Fatal pipeline error; CLI prints .message to stderr and exits 1."""

    def __init__(self, message: str):
        super().__init__(message)
        self.message = message
