"""A 6 x 10 bitmap font of printable ASCII for the figure rasterizer (the
card's machine has no font files and no matplotlib).

Each glyph is ten rows of six bits, the top row first and the leftmost
pixel in the high bit, written as 20 hex digits. The glyphs are DejaVu Sans
Mono (Bitstream Vera licence) hinted in monochrome at 10 pixels, with the
baseline under row 7. Text is drawn at an integer scale: every pixel of a
glyph becomes a ``scale`` x ``scale`` block, and every character advances
by ``6 * scale`` pixels. Characters outside printable ASCII draw as ``?``.

:func:`plain_text` turns matplotlib's math text into its plain letters:
``r"$\\mathbf{z}^{(i)}$"`` is drawn as ``z(i)``.
"""

from __future__ import annotations

import re

import numpy as np

WIDTH, HEIGHT = 6, 10
FIRST = 32  # the space

# Glyphs of the characters 32 (space) to 126 (~), four to a line.
_HEX = (
    "00000000000000000000", "00040404040400040000", "000a0a0a000000000000", "000a0a1f143e14140000",  #   ! " #
    "00040f141c07051e0400", "0038283a0c1705070000", "000e080c1513120d0000", "00040404000000000000",  # $ % & '
    "04080808080808080400", "08080404040404080800", "00150e0e150000000000", "000004041f0404000000",  # ( ) * +
    "00000000000000080808", "00000000000e00000000", "00000000000000080000", "00010202040408081000",  # , - . /
    "000e11111511110e0000", "001c04040404041f0000", "000e11010306081f0000", "000e11010e01110e0000",  # 0 1 2 3
    "0002060a1a1f02020000", "001e101e0101011e0000", "000f18101e11110e0000", "001f0302020404080000",  # 4 5 6 7
    "000e11110e11110e0000", "000e11110f01031e0000", "00000008000000080000", "00000008000000080808",  # 8 9 : ;
    "0000010e100e01000000", "0000003e003e00000000", "0000100e010e10000000", "001e0204080800080000",  # < = > ?
    "000e0917151515170806", "0004040a0a0e11110000", "001e11111e11111e0000", "000f19101010190f0000",  # @ A B C
    "001e13111111131e0000", "001f10101f10101f0000", "001f10101f1010100000", "000e19101311190f0000",  # D E F G
    "001111111f1111110000", "001f04040404041f0000", "000e02020202120c0000", "00111214181412110000",  # H I J K
    "001010101010101f0000", "00111b1b151111110000", "00111919151313110000", "000e11111111110e0000",  # L M N O
    "001e11111e1010100000", "000e11111111110e0300", "001e11111e1311100000", "000e11100e01110e0000",  # P Q R S
    "001f0404040404040000", "001111111111110e0000", "0011110a0a0a04040000", "00212d2d1e1212120000",  # T U V W
    "00110a0a040a0a110000", "00110a0a040404040000", "001f02020408081f0000", "0c080808080808080c00",  # X Y Z [
    "00100808040402020100", "0c040404040404040c00", "00081422000000000000", "0000000000000000003f",  # \\ ] ^ _
    "10080000000000000000", "0000001e010f111f0000", "1010101e1111111e0000", "0000000e1010100e0000",  # ` a b c
    "0101010f1111110f0000", "0000000e111f100f0000", "0608081e080808080000", "0000000f1111110f010e",  # d e f g
    "10101016191111110000", "0400000c0404041f0000", "0400001c040404040418", "10101012141c12110000",  # h i j k
    "38080808080808060000", "0000001f151515150000", "00000016191111110000", "0000000e1111110e0000",  # l m n o
    "0000001e1111111e1010", "0000000f1111110f0101", "0000000f090808080000", "0000000f100f011e0000",  # p q r s
    "0008081e0808080e0000", "000000111111110f0000", "000000110a0a0a040000", "00000011150a0a0a0000",  # t u v w
    "0000001b0a040a1b0000", "000000110a0a04040418", "0000001f0204081f0000", "06040404180404040600",  # x y z {
    "04040404040404040404", "0c040404030404040c00", "000000001c0300000000",  # | } ~
)


def _unpack(digits: str) -> np.ndarray:
    rows = [int(digits[2 * k:2 * k + 2], 16) for k in range(HEIGHT)]
    return np.array([[(row >> (WIDTH - 1 - c)) & 1 for c in range(WIDTH)] for row in rows], bool)


GLYPHS = {chr(FIRST + i): _unpack(digits) for i, digits in enumerate(_HEX)}


def plain_text(text: str) -> str:
    """matplotlib's math text as its plain letters: ``$`` and the commands
    ``\\mathbf`` (any ``\\name``), braces, ``^`` and ``_`` dropped."""
    if text.count("$") < 2 or text.count("$") % 2:  # not math text: drawn as it is
        return text
    text = re.sub(r"\\[A-Za-z]+", "", text.replace("$", ""))
    return re.sub(r"[{}^_]", "", text)


def text_width(text: str, scale: int = 1) -> int:
    """Pixels a string advances: its length times the advance."""
    return len(plain_text(text)) * WIDTH * scale


def text_mask(text: str, scale: int = 1) -> np.ndarray:
    """The string's pixels as a bool mask [10 * scale, text_width]."""
    text = plain_text(text)
    if not text:
        return np.zeros((HEIGHT * scale, 0), bool)
    mask = np.concatenate([GLYPHS.get(ch, GLYPHS["?"]) for ch in text], axis=1)
    return np.repeat(np.repeat(mask, scale, axis=0), scale, axis=1)
