"""Where the frozen frontend would find optional G2P assets: nowhere.

The program looks under its data directory for extra pinyin and
polyphone tables; the benchmark installs none, so this copy reads only
the tables bundled beside it."""
from pathlib import Path


def chinese_g2p_dir() -> Path:
    return Path(__file__).resolve().parent / "data" / "absent"
