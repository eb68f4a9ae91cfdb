"""Number-to-words expansion (in-repo replacement for the num2words dep).

Port of ``thunder_tpu/text/numbers.py``, string for string. The original
framework spells numbers out through the ``num2words`` package; no such
package is needed here: spell-out is implemented for the languages of the
registered checkpoints, cardinals AND ordinals
for en/pt/de/fr/es/it/ca/pl/ru (standard orthography, incl. French 70/80/90
composition, Italian vowel elision, Slavic three-form plural declension;
ordinals in the masculine nominative/base forms num2words emits, e.g.
"42º").  Range: |n| < 10^15 for en/fr/de/it, |n| < 10^12 for pt/es/ca/pl/ru;
beyond that ``ValueError("number too large")`` — an honest refusal rather
than a silently wrong spell-out.
"""

from __future__ import annotations

__all__ = ["num2words"]

_EN_UNITS = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_EN_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy", "eighty", "ninety"]
_EN_SCALE = [(10**12, "trillion"), (10**9, "billion"), (10**6, "million"), (10**3, "thousand")]
_EN_ORD_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _en_cardinal(n: int) -> str:
    if n < 0:
        return "minus " + _en_cardinal(-n)
    if n < 20:
        return _EN_UNITS[n]
    if n < 100:
        tens, unit = divmod(n, 10)
        return _EN_TENS[tens] + ("-" + _EN_UNITS[unit] if unit else "")
    if n < 1000:
        hundreds, rest = divmod(n, 100)
        out = _EN_UNITS[hundreds] + " hundred"
        return out + (" " + _en_cardinal(rest) if rest else "")
    for scale, name in _EN_SCALE:
        if n >= scale:
            major, rest = divmod(n, scale)
            out = _en_cardinal(major) + " " + name
            return out + (" " + _en_cardinal(rest) if rest else "")
    raise ValueError(f"number too large: {n}")


def _en_ordinal(n: int) -> str:
    words = _en_cardinal(n)
    # only the final word changes
    head, sep, last = words.rpartition(" ")
    h2, s2, l2 = last.rpartition("-")
    prefix = head + sep + h2 + s2
    word = l2
    if word in _EN_ORD_IRREGULAR:
        word = _EN_ORD_IRREGULAR[word]
    elif word.endswith("y"):
        word = word[:-1] + "ieth"
    else:
        word = word + "th"
    return prefix + word


_PT_UNITS = [
    "zero", "um", "dois", "três", "quatro", "cinco", "seis", "sete", "oito",
    "nove", "dez", "onze", "doze", "treze", "quatorze", "quinze", "dezesseis",
    "dezessete", "dezoito", "dezenove",
]
_PT_TENS = ["", "", "vinte", "trinta", "quarenta", "cinquenta", "sessenta", "setenta", "oitenta", "noventa"]
_PT_HUNDREDS = [
    "", "cento", "duzentos", "trezentos", "quatrocentos", "quinhentos",
    "seiscentos", "setecentos", "oitocentos", "novecentos",
]
_PT_ORD_UNITS = [
    "", "primeiro", "segundo", "terceiro", "quarto", "quinto", "sexto",
    "sétimo", "oitavo", "nono",
]
_PT_ORD_TENS = [
    "", "décimo", "vigésimo", "trigésimo", "quadragésimo", "quinquagésimo",
    "sexagésimo", "septuagésimo", "octogésimo", "nonagésimo",
]
_PT_ORD_HUNDREDS = [
    "", "centésimo", "ducentésimo", "trecentésimo", "quadringentésimo",
    "quingentésimo", "sexcentésimo", "septingentésimo", "octingentésimo",
    "nongentésimo",
]


def _pt_cardinal(n: int) -> str:
    if n < 0:
        return "menos " + _pt_cardinal(-n)
    if n < 20:
        return _PT_UNITS[n]
    if n < 100:
        tens, unit = divmod(n, 10)
        return _PT_TENS[tens] + (" e " + _PT_UNITS[unit] if unit else "")
    if n == 100:
        return "cem"
    if n < 1000:
        hundreds, rest = divmod(n, 100)
        return _PT_HUNDREDS[hundreds] + (" e " + _pt_cardinal(rest) if rest else "")
    if n < 10**6:
        thousands, rest = divmod(n, 1000)
        head = "mil" if thousands == 1 else _pt_cardinal(thousands) + " mil"
        if not rest:
            return head
        sep = " e " if (rest < 100 or rest % 100 == 0) else " "
        return head + sep + _pt_cardinal(rest)
    if n < 10**9:
        millions, rest = divmod(n, 10**6)
        head = "um milhão" if millions == 1 else _pt_cardinal(millions) + " milhões"
        return head + (" e " + _pt_cardinal(rest) if rest else "")
    if n < 10**12:
        bilhoes, rest = divmod(n, 10**9)  # pt-BR short scale (the checkpoints' variety)
        head = "um bilhão" if bilhoes == 1 else _pt_cardinal(bilhoes) + " bilhões"
        return head + (" e " + _pt_cardinal(rest) if rest else "")
    raise ValueError(f"number too large: {n}")


def _pt_ordinal(n: int) -> str:
    if n <= 0:
        raise ValueError("ordinal must be positive")
    parts = []
    if n >= 1000:
        thousands, n = divmod(n, 1000)
        parts.append(("milésimo" if thousands == 1 else _pt_cardinal(thousands) + " milésimo"))
    if n >= 100:
        hundreds, n = divmod(n, 100)
        parts.append(_PT_ORD_HUNDREDS[hundreds])
    if n >= 10:
        tens, n = divmod(n, 10)
        parts.append(_PT_ORD_TENS[tens])
    if n > 0:
        parts.append(_PT_ORD_UNITS[n])
    return " ".join(p for p in parts if p)


# ---------------------------------------------------------------------------
# German
# ---------------------------------------------------------------------------

_DE_UNITS = [
    "null", "eins", "zwei", "drei", "vier", "fünf", "sechs", "sieben", "acht",
    "neun", "zehn", "elf", "zwölf", "dreizehn", "vierzehn", "fünfzehn",
    "sechzehn", "siebzehn", "achtzehn", "neunzehn",
]
_DE_TENS = ["", "", "zwanzig", "dreißig", "vierzig", "fünfzig", "sechzig", "siebzig", "achtzig", "neunzig"]


def _de_below_thousand(n: int) -> str:
    # "ein" (not "eins") inside compounds
    if n == 0:
        return ""
    out = ""
    if n >= 100:
        h, n = divmod(n, 100)
        out += ("ein" if h == 1 else _DE_UNITS[h]) + "hundert"
    if n == 0:
        return out
    if n == 1:
        return out + "eins"
    if n < 20:
        return out + _DE_UNITS[n]
    tens, unit = divmod(n, 10)
    if unit:
        return out + ("ein" if unit == 1 else _DE_UNITS[unit]) + "und" + _DE_TENS[tens]
    return out + _DE_TENS[tens]


def _de_below_million(n: int) -> str:
    out = ""
    if n >= 1000:
        thousands, n = divmod(n, 1000)
        out = ("ein" if thousands == 1 else _de_below_thousand(thousands)) + "tausend"
    return out + _de_below_thousand(n)


def _de_cardinal(n: int) -> str:
    if n < 0:
        return "minus " + _de_cardinal(-n)
    if n == 0:
        return "null"
    if n >= 10**15:
        raise ValueError(f"number too large: {n}")
    parts = []
    for scale, one, many in ((10**9, "eine Milliarde", "Milliarden"), (10**6, "eine Million", "Millionen")):
        if n >= scale:
            major, n = divmod(n, scale)
            parts.append(one if major == 1 else _de_below_million(major) + " " + many)
    tail = ""
    if n >= 1000:
        thousands, n = divmod(n, 1000)
        tail += ("ein" if thousands == 1 else _de_below_thousand(thousands)) + "tausend"
    tail += _de_below_thousand(n)
    if tail:
        parts.append(tail)
    return " ".join(parts)


# ---------------------------------------------------------------------------
# French
# ---------------------------------------------------------------------------

_FR_UNITS = [
    "zéro", "un", "deux", "trois", "quatre", "cinq", "six", "sept", "huit",
    "neuf", "dix", "onze", "douze", "treize", "quatorze", "quinze", "seize",
    "dix-sept", "dix-huit", "dix-neuf",
]
_FR_TENS = ["", "", "vingt", "trente", "quarante", "cinquante", "soixante"]


def _fr_below_hundred(n: int, final: bool) -> str:
    if n < 20:
        return _FR_UNITS[n]
    if n < 70:
        tens, unit = divmod(n, 10)
        if unit == 1:
            return _FR_TENS[tens] + " et un"
        return _FR_TENS[tens] + ("-" + _FR_UNITS[unit] if unit else "")
    if n < 80:  # soixante-dix .. soixante-dix-neuf, with "et onze"
        if n == 71:
            return "soixante et onze"
        return "soixante-" + _FR_UNITS[n - 60]
    if n == 80:
        return "quatre-vingts" if final else "quatre-vingt"
    return "quatre-vingt-" + _FR_UNITS[n - 80]


def _fr_below_thousand(n: int, final: bool) -> str:
    if n < 100:
        return _fr_below_hundred(n, final)
    h, rest = divmod(n, 100)
    head = "cent" if h == 1 else _FR_UNITS[h] + " cent"
    if rest == 0:
        return head + ("s" if h > 1 and final else "")
    return head + " " + _fr_below_hundred(rest, final)


def _fr_below_million(n: int) -> str:
    if n >= 1000:
        thousands, rest = divmod(n, 1000)
        head = "mille" if thousands == 1 else _fr_below_thousand(thousands, False) + " mille"
        return head + (" " + _fr_below_thousand(rest, True) if rest else "")
    return _fr_below_thousand(n, True)


def _fr_cardinal(n: int) -> str:
    if n < 0:
        return "moins " + _fr_cardinal(-n)
    if n == 0:
        return "zéro"
    if n >= 10**15:
        raise ValueError(f"number too large: {n}")
    parts = []
    for scale, one, many in ((10**9, "un milliard", "milliards"), (10**6, "un million", "millions")):
        if n >= scale:
            major, n = divmod(n, scale)
            # million/milliard are nouns: vingt/cent keep their plural "s"
            # before them ("quatre-vingts millions"), unlike before the
            # numeral adjective "mille"
            parts.append(one if major == 1 else _fr_below_million(major) + " " + many)
    if n >= 1000:
        thousands, n = divmod(n, 1000)
        # "mille" is invariant, and 1000 is "mille", never "un mille"
        parts.append("mille" if thousands == 1 else _fr_below_thousand(thousands, False) + " mille")
    if n:
        parts.append(_fr_below_thousand(n, True))
    return " ".join(parts)


# ---------------------------------------------------------------------------
# Spanish
# ---------------------------------------------------------------------------

_ES_UNITS = [
    "cero", "uno", "dos", "tres", "cuatro", "cinco", "seis", "siete", "ocho",
    "nueve", "diez", "once", "doce", "trece", "catorce", "quince",
    "dieciséis", "diecisiete", "dieciocho", "diecinueve",
]
_ES_TWENTIES = [
    "veinte", "veintiuno", "veintidós", "veintitrés", "veinticuatro",
    "veinticinco", "veintiséis", "veintisiete", "veintiocho", "veintinueve",
]
_ES_TENS = ["", "", "", "treinta", "cuarenta", "cincuenta", "sesenta", "setenta", "ochenta", "noventa"]
_ES_HUNDREDS = [
    "", "ciento", "doscientos", "trescientos", "cuatrocientos", "quinientos",
    "seiscientos", "setecientos", "ochocientos", "novecientos",
]


def _es_below_thousand(n: int, apocope: bool = False) -> str:
    # apocope: "un" instead of "uno" before mil/millón
    if n == 100:
        return "cien"
    out = ""
    if n >= 100:
        h, n = divmod(n, 100)
        out = _ES_HUNDREDS[h]
        if n == 0:
            return out
        out += " "
    if n < 20:
        word = _ES_UNITS[n]
        if apocope and n == 1:
            word = "un"
        return out + word
    if n < 30:
        word = _ES_TWENTIES[n - 20]
        if apocope and n == 21:
            word = "veintiún"
        return out + word
    tens, unit = divmod(n, 10)
    word = _ES_TENS[tens]
    if unit:
        u = "un" if (apocope and unit == 1) else _ES_UNITS[unit]
        word += " y " + u
    return out + word


def _es_below_million(n: int) -> str:
    """1..999999 as a cardinal with apocope on the final unit (before a noun)."""
    if n >= 1000:
        thousands, rest = divmod(n, 1000)
        head = "mil" if thousands == 1 else _es_below_thousand(thousands, apocope=True) + " mil"
        return head + (" " + _es_below_thousand(rest, apocope=True) if rest else "")
    return _es_below_thousand(n, apocope=True)


def _es_cardinal(n: int) -> str:
    if n < 0:
        return "menos " + _es_cardinal(-n)
    if n == 0:
        return "cero"
    if n >= 10**12:
        raise ValueError(f"number too large: {n}")
    parts = []
    if n >= 10**6:
        # Spanish groups by 10^6: the millions count (1..999999) is itself a
        # full cardinal ("mil quinientos millones", not the split
        # "mil millones quinientos millones")
        major, n = divmod(n, 10**6)
        parts.append("un millón" if major == 1 else _es_below_million(major) + " millones")
    if n >= 1000:
        thousands, n = divmod(n, 1000)
        parts.append("mil" if thousands == 1 else _es_below_thousand(thousands, apocope=True) + " mil")
    if n:
        parts.append(_es_below_thousand(n))
    return " ".join(parts)


# ---------------------------------------------------------------------------
# Italian
# ---------------------------------------------------------------------------

_IT_UNITS = [
    "zero", "uno", "due", "tre", "quattro", "cinque", "sei", "sette", "otto",
    "nove", "dieci", "undici", "dodici", "tredici", "quattordici", "quindici",
    "sedici", "diciassette", "diciotto", "diciannove",
]
_IT_TENS = ["", "", "venti", "trenta", "quaranta", "cinquanta", "sessanta", "settanta", "ottanta", "novanta"]


def _it_below_hundred(n: int) -> str:
    if n < 20:
        return _IT_UNITS[n]
    tens, unit = divmod(n, 10)
    stem = _IT_TENS[tens]
    if unit == 0:
        return stem
    if unit in (1, 8):  # vowel elision: ventuno, ventotto
        stem = stem[:-1]
    word = stem + _IT_UNITS[unit]
    if unit == 3:  # tre takes an accent in compounds: ventitré
        word = word[:-3] + "tré"
    return word


def _it_accent(word: str) -> str:
    """Final 'tre' takes an accent in any compound (centotré, milletré)."""
    if len(word) > 3 and word.endswith("tre"):
        return word[:-3] + "tré"
    return word


def _it_below_thousand(n: int) -> str:
    if n < 100:
        return _it_below_hundred(n)
    h, rest = divmod(n, 100)
    out = ("" if h == 1 else _IT_UNITS[h]) + "cento"
    if rest:
        # elision before 80s: centottanta
        if 80 <= rest < 90:
            out = out[:-1]
        out += _it_below_hundred(rest)
    return _it_accent(out)


def _it_below_million(n: int) -> str:
    """1..999999 fused per Italian orthography (millecinquecento)."""
    if n < 1000:
        return _it_below_thousand(n)
    thousands, rest = divmod(n, 1000)
    if thousands == 1:
        head = "mille"
    else:
        count = _it_below_thousand(thousands)
        if count.endswith("tré"):  # accent is word-final only
            count = count[:-3] + "tre"
        head = count + "mila"
    return _it_accent(head + _it_below_thousand(rest)) if rest else head


def _it_cardinal(n: int) -> str:
    if n < 0:
        return "meno " + _it_cardinal(-n)
    if n == 0:
        return "zero"
    if n >= 10**15:
        raise ValueError(f"number too large: {n}")
    parts = []
    for scale, one, many in ((10**9, "un miliardo", "miliardi"), (10**6, "un milione", "milioni")):
        if n >= scale:
            major, n = divmod(n, scale)
            parts.append(one if major == 1 else _it_below_million(major) + " " + many)
    tail = ""
    if n >= 1000:
        thousands, n = divmod(n, 1000)
        if thousands == 1:
            tail = "mille"
        else:
            count = _it_below_thousand(thousands)
            # the accent is word-final only: trentatremila, not trentatrémila
            if count.endswith("tré"):
                count = count[:-3] + "tre"
            tail = count + "mila"
    if n:
        tail = _it_accent(tail + _it_below_thousand(n))
    if tail:
        parts.append(tail)
    return " ".join(parts)


# ---------------------------------------------------------------------------
# Catalan
# ---------------------------------------------------------------------------

_CA_UNITS = [
    "zero", "un", "dos", "tres", "quatre", "cinc", "sis", "set", "vuit",
    "nou", "deu", "onze", "dotze", "tretze", "catorze", "quinze", "setze",
    "disset", "divuit", "dinou",
]
_CA_TENS = ["", "", "vint", "trenta", "quaranta", "cinquanta", "seixanta", "setanta", "vuitanta", "noranta"]
_CA_HUNDREDS = ["", "cent", "dos-cents", "tres-cents", "quatre-cents", "cinc-cents", "sis-cents", "set-cents", "vuit-cents", "nou-cents"]


def _ca_below_hundred(n: int) -> str:
    if n < 20:
        return _CA_UNITS[n]
    tens, unit = divmod(n, 10)
    if unit == 0:
        return _CA_TENS[tens]
    # 21-29 join with -i-; 31+ with plain hyphen
    sep = "-i-" if tens == 2 else "-"
    return _CA_TENS[tens] + sep + _CA_UNITS[unit]


def _ca_below_thousand(n: int) -> str:
    if n < 100:
        return _ca_below_hundred(n)
    h, rest = divmod(n, 100)
    return _CA_HUNDREDS[h] + (" " + _ca_below_hundred(rest) if rest else "")


def _ca_below_million(n: int) -> str:
    if n >= 1000:
        thousands, rest = divmod(n, 1000)
        head = "mil" if thousands == 1 else _ca_below_thousand(thousands) + " mil"
        return head + (" " + _ca_below_thousand(rest) if rest else "")
    return _ca_below_thousand(n)


def _ca_cardinal(n: int) -> str:
    if n < 0:
        return "menys " + _ca_cardinal(-n)
    if n == 0:
        return "zero"
    if n >= 10**12:
        raise ValueError(f"number too large: {n}")
    parts = []
    if n >= 10**6:
        # same 10^6 grouping as Spanish: the milions count is one cardinal
        # ("dos mil cinc-cents milions", not "dos mil milions cinc-cents milions")
        major, n = divmod(n, 10**6)
        parts.append("un milió" if major == 1 else _ca_below_million(major) + " milions")
    if n >= 1000:
        thousands, n = divmod(n, 1000)
        parts.append("mil" if thousands == 1 else _ca_below_thousand(thousands) + " mil")
    if n:
        parts.append(_ca_below_thousand(n))
    return " ".join(parts)


# ---------------------------------------------------------------------------
# Polish / Russian (three-form Slavic plural declension)
# ---------------------------------------------------------------------------


def _slavic_form(n: int, one: str, few: str, many: str) -> str:
    if n % 10 == 1 and n % 100 != 11:
        return one
    if n % 10 in (2, 3, 4) and n % 100 not in (12, 13, 14):
        return few
    return many


_PL_UNITS = [
    "zero", "jeden", "dwa", "trzy", "cztery", "pięć", "sześć", "siedem",
    "osiem", "dziewięć", "dziesięć", "jedenaście", "dwanaście", "trzynaście",
    "czternaście", "piętnaście", "szesnaście", "siedemnaście", "osiemnaście",
    "dziewiętnaście",
]
_PL_TENS = ["", "", "dwadzieścia", "trzydzieści", "czterdzieści", "pięćdziesiąt", "sześćdziesiąt", "siedemdziesiąt", "osiemdziesiąt", "dziewięćdziesiąt"]
_PL_HUNDREDS = ["", "sto", "dwieście", "trzysta", "czterysta", "pięćset", "sześćset", "siedemset", "osiemset", "dziewięćset"]


def _pl_below_thousand(n: int) -> str:
    parts = []
    if n >= 100:
        h, n = divmod(n, 100)
        parts.append(_PL_HUNDREDS[h])
    if n >= 20:
        tens, n = divmod(n, 10)
        parts.append(_PL_TENS[tens])
    if n:
        parts.append(_PL_UNITS[n])
    return " ".join(parts)


def _pl_cardinal(n: int) -> str:
    if n < 0:
        return "minus " + _pl_cardinal(-n)
    if n == 0:
        return "zero"
    if n >= 10**12:
        raise ValueError(f"number too large: {n}")
    parts = []
    for scale, (one, few, many) in (
        (10**9, ("miliard", "miliardy", "miliardów")),
        (10**6, ("milion", "miliony", "milionów")),
        (10**3, ("tysiąc", "tysiące", "tysięcy")),
    ):
        if n >= scale:
            major, n = divmod(n, scale)
            word = _slavic_form(major, one, few, many)
            head = "" if (major == 1 and scale == 10**3) else _pl_below_thousand(major) + " "
            parts.append(head + word)
    if n:
        parts.append(_pl_below_thousand(n))
    return " ".join(parts)


_RU_UNITS = [
    "ноль", "один", "два", "три", "четыре", "пять", "шесть", "семь",
    "восемь", "девять", "десять", "одиннадцать", "двенадцать", "тринадцать",
    "четырнадцать", "пятнадцать", "шестнадцать", "семнадцать",
    "восемнадцать", "девятнадцать",
]
_RU_TENS = ["", "", "двадцать", "тридцать", "сорок", "пятьдесят", "шестьдесят", "семьдесят", "восемьдесят", "девяносто"]
_RU_HUNDREDS = ["", "сто", "двести", "триста", "четыреста", "пятьсот", "шестьсот", "семьсот", "восемьсот", "девятьсот"]


def _ru_below_thousand(n: int, feminine: bool = False) -> str:
    parts = []
    if n >= 100:
        h, n = divmod(n, 100)
        parts.append(_RU_HUNDREDS[h])
    if n >= 20:
        tens, n = divmod(n, 10)
        parts.append(_RU_TENS[tens])
    if n:
        word = _RU_UNITS[n]
        if feminine and n == 1:
            word = "одна"
        elif feminine and n == 2:
            word = "две"
        parts.append(word)
    return " ".join(parts)


def _ru_cardinal(n: int) -> str:
    if n < 0:
        return "минус " + _ru_cardinal(-n)
    if n == 0:
        return "ноль"
    if n >= 10**12:
        raise ValueError(f"number too large: {n}")
    parts = []
    for scale, (one, few, many), feminine in (
        (10**9, ("миллиард", "миллиарда", "миллиардов"), False),
        (10**6, ("миллион", "миллиона", "миллионов"), False),
        (10**3, ("тысяча", "тысячи", "тысяч"), True),
    ):
        if n >= scale:
            major, n = divmod(n, scale)
            parts.append(_ru_below_thousand(major, feminine=feminine) + " " + _slavic_form(major, one, few, many))
    if n:
        parts.append(_ru_below_thousand(n))
    return " ".join(parts)


# ---------------------------------------------------------------------------
# Ordinals for the remaining registered-checkpoint languages.  The original
# framework expands ordinals ("42º") through num2words for every language;
# these cover the masculine nominative/base forms num2words emits.
# ---------------------------------------------------------------------------


def _check_ordinal(n: int) -> None:
    if n <= 0:
        raise ValueError("ordinal must be positive")


def _de_ordinal(n: int) -> str:
    """German: cardinal + te/ste with erste/dritte/siebte/achte stems; scale
    nouns fuse and take singular form (einmillionste)."""
    _check_ordinal(n)
    card = _de_cardinal(n)
    for a, b in (
        ("eine Milliarde", "einmilliard"), (" Milliarden", "milliarden"),
        ("eine Million", "einmillion"), (" Millionen", "millionen"),
    ):
        card = card.replace(a, b)
    card = card.replace(" ", "")
    r = n % 100
    if 1 <= r <= 19:
        if card.endswith("eins"):
            return card[:-4] + "erste"
        if card.endswith("drei"):
            return card[:-4] + "dritte"
        if card.endswith("sieben"):
            return card[:-6] + "siebte"
        if card.endswith("acht"):
            return card + "e"
        return card + "te"
    # singular scale noun in round ordinals: zweimillionste, einmilliardste
    if card.endswith("millionen"):
        card = card[:-2]
    elif card.endswith("milliarden"):
        card = card[:-2]
    return card + "ste"


def _fr_ordinal(n: int) -> str:
    """French: premier for 1, else cardinal + ième with the standard final-
    letter adjustments (e dropped, cinq->cinqu, neuf->neuv, plural s dropped)."""
    _check_ordinal(n)
    if n == 1:
        return "premier"
    card = _fr_cardinal(n)
    if card.endswith("e"):
        card = card[:-1]
    elif card.endswith("q"):
        card = card + "u"
    elif card.endswith("f"):
        card = card[:-1] + "v"
    elif card.endswith("s") and not card.endswith("trois"):
        card = card[:-1]  # quatre-vingts / deux cents lose the plural s
    return card + "ième"


_ES_ORD_UNITS = [
    "", "primero", "segundo", "tercero", "cuarto", "quinto", "sexto",
    "séptimo", "octavo", "noveno",
]
_ES_ORD_TENS = [
    "", "décimo", "vigésimo", "trigésimo", "cuadragésimo", "quincuagésimo",
    "sexagésimo", "septuagésimo", "octogésimo", "nonagésimo",
]
_ES_ORD_HUNDREDS = [
    "", "centésimo", "ducentésimo", "tricentésimo", "cuadringentésimo",
    "quingentésimo", "sexcentésimo", "septingentésimo", "octingentésimo",
    "noningentésimo",
]


def _es_ordinal(n: int) -> str:
    _check_ordinal(n)
    parts = []
    if n >= 10**6:
        millions, n = divmod(n, 10**6)
        head = "" if millions == 1 else _es_below_million(millions).replace(" ", "")
        parts.append(head + "millonésimo")
    if n >= 1000:
        thousands, n = divmod(n, 1000)
        head = "" if thousands == 1 else _es_below_thousand(thousands, apocope=True).replace(" ", "")
        parts.append(head + "milésimo")
    if n >= 100:
        hundreds, n = divmod(n, 100)
        parts.append(_ES_ORD_HUNDREDS[hundreds])
    if n == 11:
        parts.append("undécimo")
    elif n == 12:
        parts.append("duodécimo")
    elif 13 <= n <= 19:
        unit = _ES_ORD_UNITS[n - 10]
        # RAE fused forms: decimotercero, decimoséptimo, decimoctavo
        parts.append(("decim" if unit.startswith("o") else "decimo") + unit)
    else:
        if n >= 10:
            tens, n = divmod(n, 10)
            parts.append(_ES_ORD_TENS[tens])
        if n:
            parts.append(_ES_ORD_UNITS[n])
    return " ".join(p for p in parts if p)


_IT_ORD_UNITS = [
    "", "primo", "secondo", "terzo", "quarto", "quinto", "sesto", "settimo",
    "ottavo", "nono", "decimo",
]


def _it_ordinal(n: int) -> str:
    """Italian: irregular 1-10, else cardinal + esimo with the final vowel
    dropped (-tré keeps its e unaccented: ventitreesimo; -sei keeps the i)."""
    _check_ordinal(n)
    if n <= 10:
        return _IT_ORD_UNITS[n]
    if n == 10**6:
        return "milionesimo"
    if n == 10**9:
        return "miliardesimo"
    card = _it_cardinal(n)
    for a, b in (
        ("un miliardo", "unmiliardo"), (" miliardi", "miliardi"),
        ("un milione", "unmilione"), (" milioni", "milioni"),
    ):
        card = card.replace(a, b)
    if card.endswith("tré"):
        return card[:-3] + "treesimo"
    if card.endswith("sei"):
        return card + "esimo"
    return card[:-1] + "esimo"


_CA_ORD_UNITS = [
    "", "primer", "segon", "tercer", "quart", "cinquè", "sisè", "setè",
    "vuitè", "novè", "desè",
]


def _ca_ordinal(n: int) -> str:
    """Catalan: irregular 1-4, else cardinal + è with final-letter rules
    (cinc->cinquè, nou->novè, deu->desè, vowels dropped, -cents -> -centè)."""
    _check_ordinal(n)
    if n <= 10:
        return _CA_ORD_UNITS[n]
    card = _ca_cardinal(n)
    for a, b in (("un milió", "milion"), (" milions", "milions")):
        card = card.replace(a, b)
    if card.endswith("deu"):
        return card[:-3] + "desè"
    if card.endswith("nou"):
        return card[:-2] + "ovè"
    if card.endswith("cinc"):
        return card[:-1] + "què"
    if card.endswith("cents"):
        return card[:-1] + "è"
    if card.endswith("milions"):
        return card[:-1] + "è"
    if card[-1] in "aeiou":
        return card[:-1] + "è"
    return card + "è"


_PL_ORD_UNITS = [
    "", "pierwszy", "drugi", "trzeci", "czwarty", "piąty", "szósty", "siódmy",
    "ósmy", "dziewiąty", "dziesiąty", "jedenasty", "dwunasty", "trzynasty",
    "czternasty", "piętnasty", "szesnasty", "siedemnasty", "osiemnasty",
    "dziewiętnasty",
]
_PL_ORD_TENS = [
    "", "", "dwudziesty", "trzydziesty", "czterdziesty", "pięćdziesiąty",
    "sześćdziesiąty", "siedemdziesiąty", "osiemdziesiąty", "dziewięćdziesiąty",
]
_PL_ORD_HUNDREDS = [
    "", "setny", "dwusetny", "trzechsetny", "czterechsetny", "pięćsetny",
    "sześćsetny", "siedemsetny", "osiemsetny", "dziewięćsetny",
]
_PL_THOUSAND_PREFIX = [
    "", "", "dwu", "trzy", "cztero", "pięcio", "sześcio", "siedmio", "ośmio",
    "dziewięcio",
]


def _pl_ordinal(n: int) -> str:
    """Polish masculine nominative.  Only the lowest nonzero component takes
    the ordinal form; everything above it stays cardinal ("sto dwudziesty
    pierwszy"); round hundreds/thousands use their fused forms."""
    _check_ordinal(n)
    r2 = n % 100
    if r2:
        prefix = _pl_cardinal(n - r2) + " " if n >= 100 else ""
        if r2 < 20:
            return prefix + _PL_ORD_UNITS[r2]
        tens, unit = divmod(r2, 10)
        word = _PL_ORD_TENS[tens] + (" " + _PL_ORD_UNITS[unit] if unit else "")
        return prefix + word
    r3 = n % 1000
    if r3:
        prefix = _pl_cardinal(n - r3) + " " if n >= 1000 else ""
        return prefix + _PL_ORD_HUNDREDS[r3 // 100]
    thousands = n // 1000
    if thousands and n % 10**6 == 0 and n // 10**6 < 10:
        m = n // 10**6
        return ("" if m == 1 else _PL_THOUSAND_PREFIX[m]) + "milionowy"
    if thousands < 10:
        return ("" if thousands == 1 else _PL_THOUSAND_PREFIX[thousands]) + "tysięczny"
    # best-effort for large round thousands: cardinal count + tysięczny
    return _pl_cardinal(thousands) + " tysięczny"


_RU_ORD_UNITS = [
    "", "первый", "второй", "третий", "четвёртый", "пятый", "шестой",
    "седьмой", "восьмой", "девятый", "десятый", "одиннадцатый",
    "двенадцатый", "тринадцатый", "четырнадцатый", "пятнадцатый",
    "шестнадцатый", "семнадцатый", "восемнадцатый", "девятнадцатый",
]
_RU_ORD_TENS = [
    "", "", "двадцатый", "тридцатый", "сороковой", "пятидесятый",
    "шестидесятый", "семидесятый", "восьмидесятый", "девяностый",
]
_RU_ORD_HUNDREDS = [
    "", "сотый", "двухсотый", "трёхсотый", "четырёхсотый", "пятисотый",
    "шестисотый", "семисотый", "восьмисотый", "девятисотый",
]
_RU_GEN_PREFIX = [
    "", "", "двух", "трёх", "четырёх", "пяти", "шести", "семи", "восьми",
    "девяти",
]


def _ru_ordinal(n: int) -> str:
    """Russian masculine nominative.  Like Polish, only the lowest nonzero
    component is ordinal ("сто двадцать первый"); round hundreds/thousands/
    millions take fused genitive-prefix forms (двухтысячный)."""
    _check_ordinal(n)
    r2 = n % 100
    if r2:
        prefix = _ru_cardinal(n - r2) + " " if n >= 100 else ""
        if r2 < 20:
            return prefix + _RU_ORD_UNITS[r2]
        tens, unit = divmod(r2, 10)
        if unit:
            return (_ru_cardinal(n - unit) + " ") + _RU_ORD_UNITS[unit]
        return prefix + _RU_ORD_TENS[tens]
    r3 = n % 1000
    if r3:
        prefix = _ru_cardinal(n - r3) + " " if n >= 1000 else ""
        return prefix + _RU_ORD_HUNDREDS[r3 // 100]
    if n % 10**6 == 0 and n // 10**6 < 10:
        m = n // 10**6
        return ("" if m == 1 else _RU_GEN_PREFIX[m]) + "миллионный"
    thousands = n // 1000
    if thousands < 10:
        return ("" if thousands == 1 else _RU_GEN_PREFIX[thousands]) + "тысячный"
    return _ru_cardinal(thousands) + " тысячный"


_CARDINALS = {
    "en": _en_cardinal,
    "pt": _pt_cardinal,
    "de": _de_cardinal,
    "fr": _fr_cardinal,
    "es": _es_cardinal,
    "it": _it_cardinal,
    "ca": _ca_cardinal,
    "pl": _pl_cardinal,
    "ru": _ru_cardinal,
}
_ORDINALS = {
    "en": _en_ordinal,
    "pt": _pt_ordinal,
    "de": _de_ordinal,
    "fr": _fr_ordinal,
    "es": _es_ordinal,
    "it": _it_ordinal,
    "ca": _ca_ordinal,
    "pl": _pl_ordinal,
    "ru": _ru_ordinal,
}


def num2words(number: int, lang: str = "en", to: str = "cardinal") -> str:
    """Spell out ``number`` in ``lang``.

    Cardinals and ordinals: en, pt, de, fr, es, it, ca, pl, ru (the
    registered checkpoints' languages).
    """
    number = int(number)
    code = lang.split("_")[0].split("-")[0].lower()
    if to == "ordinal":
        fn = _ORDINALS.get(code)
        if fn is None:
            raise NotImplementedError(
                f"ordinal spell-out not supported for language: {lang} (supported: {sorted(_ORDINALS)})"
            )
        return fn(number)
    fn = _CARDINALS.get(code)
    if fn is None:
        raise NotImplementedError(
            f"language not supported: {lang} (supported: {sorted(_CARDINALS)})"
        )
    return fn(number)
