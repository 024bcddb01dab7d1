"""Plain-text run logger (counterpart of gaussianimage_tpu/utils/logwriter.py):
prints and appends to train.txt / test.txt in the log dir."""

from __future__ import annotations

import os


class LogWriter:
    def __init__(self, file_path, train: bool = True):
        os.makedirs(file_path, exist_ok=True)
        self.file_path = os.path.join(
            file_path, "train.txt" if train else "test.txt")

    def write(self, text: str) -> None:
        print(text)
        with open(self.file_path, "a") as f:
            f.write(text + "\n")
