"""Bitstream header codecs and the ``.bin`` container (the port's copy of
``crdr_tpu/utils/codec_utils.py``).

Byte-layout contract matches the reference (src/utils/codec_utils.py):

* ``HeaderHandler``:        H,W as uint16-LE, max|y_hat| as uint8.
* ``MultiRateHeaderHandler``: + rate_ind quantized as ``int(q * 16)`` uint8.
* ``.bin``: per string, its length as uint32-LE, then its bytes.
"""

from __future__ import annotations

from typing import Dict, List, Tuple, Union

import numpy as np


class HeaderHandler:
    @staticmethod
    def check_img_size(img_size: Tuple[int, int]) -> None:
        assert len(img_size) == 2
        assert all(isinstance(v, (int, np.integer)) for v in img_size)

    def encode(self, img_size: Tuple[int, int], y_hat) -> bytes:
        self.check_img_size(img_size)
        max_val = int(np.max(np.abs(np.asarray(y_hat))))
        parts = [
            np.array(list(img_size), dtype=np.uint16).tobytes(),
            np.array(max_val, dtype=np.uint8).tobytes(),
        ]
        return b"".join(parts)

    def decode(self, header: bytes) -> Dict:
        img_size = np.frombuffer(header[:4], dtype=np.uint16)
        max_sample = int(np.frombuffer(header[4:5], dtype=np.uint8)[0])
        return {
            "img_size": (int(img_size[0]), int(img_size[1])),
            "max_sample": max_sample,
        }


class MultiRateHeaderHandler(HeaderHandler):
    def encode(self, img_size: Tuple[int, int], y_hat,
               rate_ind: Union[float, int]) -> bytes:
        rate_q = int(float(rate_ind) * 16)
        assert 0 <= rate_q <= 255
        base = super().encode(img_size, y_hat)
        return base + np.array(rate_q, dtype=np.uint8).tobytes()

    def decode(self, header: bytes) -> Dict:
        out = super().decode(header)
        rate_q = int(np.frombuffer(header[5:6], dtype=np.uint8)[0])
        out["rate_ind"] = float(rate_q) / 16.0
        return out


def pack_byte_strings(string_list: List[bytes]) -> bytes:
    """In-memory ``.bin`` container: per string, uint32-LE length + raw bytes
    (identical to the on-disk layout)."""
    return b"".join(np.uint32(len(s)).tobytes() + bytes(s)
                    for s in string_list)


def unpack_byte_strings(data: bytes) -> List[bytes]:
    out: List[bytes] = []
    pos = 0
    while pos < len(data):
        if pos + 4 > len(data):
            raise ValueError("truncated container: dangling length prefix")
        length = int(np.frombuffer(data[pos:pos + 4], dtype=np.uint32)[0])
        pos += 4
        if pos + length > len(data):
            raise ValueError("truncated container: string exceeds payload")
        out.append(data[pos:pos + length])
        pos += length
    return out


def save_byte_strings(save_path: str, string_list: List[bytes]) -> None:
    with open(save_path, "wb") as f:
        f.write(pack_byte_strings(string_list))


def load_byte_strings(load_path: str) -> List[bytes]:
    with open(load_path, "rb") as f:
        return unpack_byte_strings(f.read())
