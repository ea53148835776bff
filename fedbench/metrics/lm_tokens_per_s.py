"""Every client's training tokens of the window over the window's time."""
from fedbench.readers import round_s


def read(record):
    tokens = record["work"].get("round_tokens")
    return tokens / round_s(record) if tokens else None
