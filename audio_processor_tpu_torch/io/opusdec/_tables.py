"""RFC 6716 normative constant tables for the first-party
Opus decoder (GENERATED by tools/gen_opus_tables.py — do not
edit).  These are interoperability constants defined by the
Opus specification (RFC 6716 sections 4.2-4.3 and the
reference ROM); recovered from the system libopus data
section and cross-checked byte-for-byte against a second,
independently compiled libopus build."""

import base64

import numpy as np


def _t(b64, dtype, shape):
    a = np.frombuffer(base64.b64decode(b64), dtype=dtype)
    a = a.reshape(shape)
    a.setflags(write=False)
    return a

CELT_ALLOC_VECTORS = _t(
    "AAAAAAAAAAAAAAAAAAAAAAAAAAAAWlBLRT84MSgiHRQSCgAAAAAAAAAAbmRa"
    "VE5HQTozLScgGhQMAAAAAAAAdm5nXVZQS0ZBOzUvKB8XDwQAAAAAfndwaF9Z"
    "U05IQjw2LycgGREMAQAAhn94cmdhW1VOSEI8Ni8pIx0XEAoBkImCfHFrZV9Y"
    "UkxGQDkzLSchGg8BmJGKhHt1b2liXFZQSkM9NzErJBQBopuUjoV/eXNsZmBa"
    "VE1HQTs1Lh4BrKWemI+Jg312cGpkXldRS0U/OC0UyMjIyMjIyMjGwby3sq2o"
    "o56ZlIFo",
    np.dtype('|u1'), (11, 21))
CELT_BETA_COEF = _t(
    "AIZrPwAULj8AcL0+ANBMPg==",
    np.dtype('<f4'), (4,))
CELT_BETA_INTRA = _t(
    "AJgZPg==",
    np.dtype('<f4'), (1,))
CELT_BIT_DEINTERLEAVE = _t(
    "AAMMDzAzPD/Aw8zP8PP8/w==",
    np.dtype('|u1'), (16,))
CELT_BIT_INTERLEAVE = _t(
    "AAEBAQIDAwMCAwMDAgMDAw==",
    np.dtype('|u1'), (16,))
CELT_CACHE_BITS = _t(
    "KAcHBwcHBwcHBwcHBwcHBwcHBwcHBwcHBwcHBwcHBwcHBwcHBwcHBwcoDxcc"
    "HyIkJicpKissLS4vLzEyMzQ1Njc3OTo7PD0+Pz9BQkNERUZHRygUISkwNTk9"
    "QEJFR0lLTE5QUlVXWVtcXmBiZWdpa2xucHJ1d3l7fH6AKBcnMzxDSU9TV1te"
    "YWRmaWtvc3Z5fH6Bg4eLjpGUlpmbn6OmqayusbMjHDFBTllja3J4foSIjZGV"
    "mZ+lq7C0ub3Ax83T2Nzh5ejv9fsVITpPYXB9iZSdpq62vcPJz9nj6/P7ESM/"
    "Vmp7i5ilsbvFztbe5u36GR83S1tpdYCKkpqhqK60ub7I0Nfe5evw9f8QJEFZ"
    "boCQn625xM/Z4ury+gspSmeAl6y/0eHx/wkrT26Ko7rP4/YMJ0dje5CktsbW"
    "5PH9CSxRcY6owNbr/wcxWn+gv9z3BjNfhqrL6gcvV3ubuNTtBjRhia7Q8AU5"
    "apfA5wU7b57K8wU3Z5O74AU8caHO+ARBeq/gBEN/tuo=",
    np.dtype('|u1'), (392,))
CELT_CACHE_CAPS = _t(
    "4ODg4ODg4OCgoKCgubm5srKohj0l4ODg4ODg4ODw8PDwz8/Pxsa3kEIooKCg"
    "oKCgoKC5ubm5wcHBt7esikAm8PDw8PDw8PDPz8/PzMzMwcG0j0Ioubm5ubm5"
    "ubnBwcHBwcHBt7esikEnz8/Pz8/Pz8/MzMzMycnJvLywjUIowcHBwcHBwcHB"
    "wcHBwsLCuLiti0EnzMzMzMzMzMzJycnJxsbGu7uvjEIo",
    np.dtype('|u1'), (4, 2, 21))
CELT_CACHE_INDEX = _t(
    "/////////////////////wAAAAAAAAAAKQApACkAUgBSAHsApADIAN4AAAAA"
    "AAAAAAAAAAAAAAAAACkAKQApACkAewB7AHsApACkAPAACgEbAScBKQApACkA"
    "KQApACkAKQApAHsAewB7AHsA8ADwAPAACgEKATEBPgFIAVABewB7AHsAewB7"
    "AHsAewB7APAA8ADwAPAAMQExATEBPgE+AVcBXwFmAWwB8ADwAPAA8ADwAPAA"
    "8ADwADEBMQExATEBVwFXAVcBXwFfAXIBeAF+AYMB",
    np.dtype('<i2'), (5, 21))
CELT_EBANDS = _t(
    "AAABAAIAAwAEAAUABgAHAAgACgAMAA4AEAAUABgAHAAiACgAMAA8AE4AZAA=",
    np.dtype('<i2'), (22,))
CELT_E_MEANS = _t(
    "AADOQAAAyEAAALhAAACqQAAAokAAAJpAAACQQAAAjEAAAJxAAACWQAAAkkAA"
    "AI5AAACcQAAAlEAAAIpAAACQQAAAjEAAAJRAAACYQAAAjkAAAHBAAABwQAAA"
    "cEAAAHBAAABwQA==",
    np.dtype('<f4'), (25,))
CELT_E_PROB_MODEL = _t(
    "SH9BgUKAQYBAgD6AQIBAgFxOXE9cTlpPdClzKHIohBqEGpERoQywCrELGLMw"
    "ijaHNoQ1hjiFN4Q3hD1yRmBKWEtYV0pZQltDZDtsMngoeiVhK04yU05UUVhL"
    "VkpXR1pJXUpdSm0ociR1InUijxGREpITogylCrIHvQa+CLEJF7I2cz9mQmJF"
    "Y0pZR1tJW05ZVlBcQl1AZjtnPGg8dTR7LIojhR9hJk0tPVpdPGkqayluLXQm"
    "cSZwJnwahBuIE4wUmw6fEJ4Sqg2xCrsIwAavCZ8KFbI7bkdWS1VUU1tCWElX"
    "SFxLYkhpOms2czRyN3A4gTOEKJYhjB1iI00qKnlgQmwrbyh1LHsgeCR3IX8h"
    "hiKLFZMXmBSeGZoaphWtELgNuAqWDYsPFrI/ckpSVFNcUmc+YEhgQ2VJa0hx"
    "N3Y0fTR2NHU3hzGJJ50gkR1hIU0o",
    np.dtype('|u1'), (4, 2, 42))
CELT_LOG2_FRAC = _t(
    "AAgNEBMVFxgaGxwdHh8gICEiIiMkJCUl",
    np.dtype('|u1'), (24,))
CELT_LOGN = _t(
    "AAAAAAAAAAAAAAAAAAAAAAgACAAIAAgAEAAQABAAFQAVABgAHQAiACQA",
    np.dtype('<i2'), (21,))
CELT_ORDERY = _t(
    "AQAAAAAAAAADAAAAAAAAAAIAAAABAAAABwAAAAAAAAAEAAAAAwAAAAYAAAAB"
    "AAAABQAAAAIAAAA=",
    np.dtype('<i4'), (14,))
CELT_POSTFILTER_GAINS = _t(
    "AACdPgBAXj4AwAQ+AIDtPgBAiT4AAAAAAMBMPwAAzT0AAAAA",
    np.dtype('<f4'), (3, 3))
CELT_PRED_COEF = _t(
    "AABmPwAATD8AACY/AAAAPw==",
    np.dtype('<f4'), (4,))
CELT_PREEMPH = _t(
    "AJpZPwAAAAAAAIA/AACAPw==",
    np.dtype('<f4'), (4,))
CELT_SPREAD_ICDF = _t(
    "GRcCAA==",
    np.dtype('|u1'), (4,))
CELT_TAPSET_ICDF = _t(
    "AgEA",
    np.dtype('|u1'), (3,))
CELT_TF_SELECT = _t(
    "AP8A/wD/AP8A/wD+AQAB/wD+AP0CAAH/AP4A/QMAAf8=",
    np.dtype('|i1'), (4, 8))
CELT_TRIM_ICDF = _t(
    "fnx3bVcpEwkEAgA=",
    np.dtype('|u1'), (11,))
CELT_WINDOW = _t(
    "ahyNOFK7HjoIadw6gu1XO4ljsjsDKgU8MNw5PLQ+dzwco5480fLFPP6G8Tyb"
    "qxA9Ba0qPYTCRj1T5mQ9EYmCPYefkz3LsqU90b64PTq/zD1Ur+E9FIr3PQ4l"
    "Bz7Z9BI+XzEfPmjXKz6K4zg+MFJGPpQfVD6/R2I+jsZwPrCXfz5SW4c+YA+P"
    "Ppjllj55254+cO6mPtgbrz77YLc+Ebu/PkYnyD63otA+eCrZPpS74T4MU+o+"
    "3u3yPgaJ+z6+EAI/H1oGPySfCj9Q3g4/KxYTP0FFFz8lahs/c4MfP86PIz/m"
    "jSc/dHwrPz9aLz8ZJjM/5942P5mDOj8zEz4/xYxBP3fvRD9/Okg/J21LP86G"
    "Tj/lhlE/8WxUP444Vz9p6Vk/RX9cP/r5Xj9zWWE/r51jP8HGZT/P1Gc/Echp"
    "P9Kgaz9uX20/UARvP/SPcD/mAnI/vV1zPx+hdD+/zXU/V+R2P7Dldz+X0ng/"
    "46t5P3Nyej8nJ3s/58p7P51efD8143w/nFl9P73CfT+GH34/3nB+P6u3fj/P"
    "9H4/Jil/P4ZVfz++en8/lpl/P8yyfz8Ux38/HNd/P4Ljfz/d7H8/tvN/P4r4"
    "fz/I+38/1v1/Pwf/fz+l/38/6P9/P/3/fz8AAIA/",
    np.dtype('<f4'), (120,))
SILK_CB_LAGS_STAGE2 = _t(
    "AAL///8AAAEBAAEAAQAAAAAAAQAAAAAAAQAAAAEAAAAAAP8CAQABAQAA//8=",
    np.dtype('|i1'), (4, 11))
SILK_CB_LAGS_STAGE2_10MS = _t(
    "AAEAAAAB",
    np.dtype('|i1'), (2, 3))
SILK_CB_LAGS_STAGE3 = _t(
    "AAAB/wAB/wD/Af4C/v4C/QID/fwD/AQE+wX6+wb5BgUI9wAAAQAAAAAAAAD/"
    "AQAAAf8AAf//Af8CAf8C/v4C/gICA/0AAQAAAAAAAAEAAQAAAf8BAAACAf8C"
    "//8C/wIC/wP+/v4DAAEAAAEAAf8C/wL/AgP+A/7+BAT9Bf38BvwGBfsI+vv5"
    "CQ==",
    np.dtype('|i1'), (4, 34))
SILK_CB_LAGS_STAGE3_10MS = _t(
    "AAAB/wH/Av4C/gP9AAEAAf8C/wL+A/4D",
    np.dtype('|i1'), (2, 12))
SILK_DELTA_GAIN_ICDF = _t(
    "+vXqy0cyKiYjIR8dHBsaGRgXFhUUExIREA8ODQwLCgkIBwYFBAMCAQA=",
    np.dtype('|u1'), (41,))
SILK_GAIN_ICDF = _t(
    "4HAsDwMCAQD+7cCERhcEAP/84ps9CwIA",
    np.dtype('|u1'), (3, 8))
SILK_LBRR_FLAGS_2_ICDF = _t(
    "y5YA",
    np.dtype('|u1'), (3,))
SILK_LBRR_FLAGS_3_ICDF = _t(
    "18OmfW5SAA==",
    np.dtype('|u1'), (7,))
SILK_LSB_ICDF = _t(
    "eAA=",
    np.dtype('|u1'), (2,))
SILK_LSF_COS_Q12 = _t(
    "ACD+H/Yf6h/YH8IfqB+IH2IfOh8KH9geoB5iHiIe3B2QHUId7hyWHDoc2Bty"
    "GwobnBoqGrQZOhm8GDwYthcuF6AWEBZ+FegUThSwExATbhLIER4RdBDGDxYP"
    "ZA6uDfgMQAyEC8gKCgpKCYoIxgcCBz4GeAWyBOoDIgNaApIBygAAADb/bv6m"
    "/d78FvxO+4j6wvn++Dr4dve29vb1OPV89MDzCPNS8pzx6vA68Izv4u447pLt"
    "8OxQ7LLrGOuC6vDpYOnS6EroxOdE58bmTObW5WTl9uSO5CjkxuNq4xLjvuJw"
    "4iTi3uGe4WDhKOH24MbgnuB44FjgPuAo4BbgCuAC4ADg",
    np.dtype('<i2'), (129,))
SILK_LTPSCALE_ICDF = _t(
    "gEAA",
    np.dtype('|u1'), (3,))
SILK_LTP_GAIN_ICDF_0 = _t(
    "RzgrHhUMBgA=",
    np.dtype('|u1'), (8,))
SILK_LTP_GAIN_ICDF_1 = _t(
    "x6WQfG1gVEc9MyogFw8IAA==",
    np.dtype('|u1'), (16,))
SILK_LTP_GAIN_ICDF_2 = _t(
    "8eHTx7uvpJmOhHtyaWBYUEhAOTIsJiEdGBQQDAkFAgA=",
    np.dtype('|u1'), (32,))
SILK_LTP_GAIN_VQ_0 = _t(
    "BAYYBwUAAAIAAAwcKQ389w8qGQ4B/j4p9/YlQfwD+gRCB/gQDib9IQ==",
    np.dtype('|i1'), (8, 5))
SILK_LTP_GAIN_VQ_1 = _t(
    "DRYnFwz/JEAb+vkKNysRAQEIAQEG9Uo19/Q3TPQI/QNdG/waJzsD+AIATQsJ"
    "+BYs+gcoCRoDCfkUZfkEA/gqGgDxIUQCF/43Lv4PA/8VECk=",
    np.dtype('|i1'), (16, 5))
SILK_LTP_GAIN_VQ_2 = _t(
    "+hs9JwX1KlgEAf48QQb8//tJOAH3E14d9wAMYwYECO1mLvMDAg0DAgnrVEju"
    "9S5o6ggSJjAXAPBGU+sLBfV1Fvj6F3X0AwP4XxwE9g9NPPH/BHwC/AMmVBjn"
    "Ag0qDR8V/Dgu//8jT/MT+UFY9/IUBFEx4xQASwPvBfcsXPgB/RZFH/pfKfQF"
    "J0MQ/AEA+ng33PMsegToUQULAwcCAAkKWA==",
    np.dtype('|i1'), (32, 5))
SILK_LTP_PER_INDEX_ICDF = _t(
    "s2MA",
    np.dtype('|u1'), (3,))
SILK_LTP_SCALES_Q14 = _t(
    "zTwAMAAg",
    np.dtype('<i2'), (3,))
SILK_MAX_PULSES = _t(
    "CAoMEA==",
    np.dtype('|u1'), (4,))
SILK_NLSF_EXT_ICDF = _t(
    "ZCgQBwMBAA==",
    np.dtype('|u1'), (7,))
SILK_NLSF_INTERP_ICDF = _t(
    "893AtQA=",
    np.dtype('|u1'), (5,))
SILK_NLSF_NB_MB_CB1_ICDF = _t(
    "1LKUgWxgVVJPTT07OTgzMTAtKikoJiQiHx4VDAoDAQD/9fTs6eHZy76wr6GV"
    "iH1yZltRRzw0KyMcFBMSDAsFAA==",
    np.dtype('|u1'), (2, 32))
SILK_NLSF_NB_MB_CB1_Q8 = _t(
    "DCM8U2yEnbTO5A8gN01lfZevyeETKkJZcomiuNHmDBkySGF4k6zI3xosRVpy"
    "h5+0zeENFjVQaoKctM3kDxksQFpzjqjE3hMYPlJkeJGovtYWHzJPZ3iXqsvj"
    "FR0tQWp8lqvE4B4xS2F5jqW60eUTGTRGXXSPpsDbGiI+S2F2kafC2RkhOEZb"
    "cY+lxN8VIjNIYXWRq8TeFB0yQ1p1kKjF3RYfMEJfdZKoxN4YITNNdIaetMjg"
    "FRxGV2p8larC2RohNUBTdZitzOEbIkFfbIGbrtLhFBpIY3GDmrDI2yIrPU5d"
    "cpuxzeUXHTZhfIqjs9HlHiY4WXaBnrLI5xUdMT9Vb46jwd4bME1nhZ6zxNfo"
    "HS9KY3yXsMbc7SEqPUxdeZuuz+EdNVdwiJqqvNDjGB40VIOWprrL5SUwQFRo"
    "dpyxyeY=",
    np.dtype('|u1'), (32, 10))
SILK_NLSF_NB_MB_CB1_WGHT_Q9 = _t(
    "UQsKCQoJCgnvCO8ICgn8CBcJ7whICxQKWgk/CQoJ4gjiCOII4giSCLcJJAkk"
    "CQoJCgkKCSQJJAk/CTIJkAzOCiQJJAkKCeIIrQifCNUIkgicCaoJPwlaCVoJ"
    "WglaCT8JZwkKCZcN8AtPCJ8I4gjiCOII7wgKCdUI0gxFDBQKWgnHCK0InwiS"
    "CJIIQggAEAUPrQg8CjwKZwkKCVoJPwkaCGoMrAw/Ca0I+QmCCSQJCgl3CK0I"
    "Cg2gDaYKkgjVCJwJMgk/CZ8INQgyCXQJFwk/CVoJdAl0CXQJnAk/CcMOLQ6C"
    "Cd8JPwniCOII/AifCAAItgyZDJkKHguPCRcJ/Aj8COIITwi/DOQMwQr2Co8J"
    "1QjVCMcITwg1CDkLpQtJCj8JZwkyCZIIxwjHCEIImQx9DEkKFAriCIUIxwit"
    "CK0IXQhqDO4MtApnCeII4gjiCO8IkghCCEUMyAycCQ0I7wjECT8JtwmCCYUI"
    "sw3SDAoJjApXCqoJPwlaCSQJTwhfDc8N3gvwC/wIngetCOII4gjiCEwNJg0n"
    "CH8KOQsyCXQJ4giqCewJsA6gDZ4HZApRC98JWgk/CZwJ1QjUC8gMtApIC7QK"
    "aghPCO8IugjHCG8OSQ7pB7EHZAqMChQKxAkXCT8JhwxVDTIJGghIC0gLJAm3"
    "CccIdwgKDSYNHgvcChcJagjiCO8IQggNCBcJ/AiFCHcIhQg/CUkKjAqMCvkJ"
    "ZwmCCa0I1QitCK0IJAl0CS8KjAreC6wM9gpIC6oJGgj8CAoJMglMCa0IaghP"
    "CO8IxAnpCukKPAoUCj8JXA6BDroILgeFCMEKpgpxCtEJnwjpClgMpgr5CR4L"
    "0QmFCFoJrQiFCA==",
    np.dtype('<i2'), (32, 10))
SILK_NLSF_NB_MB_DELTA_MIN_Q15 = _t(
    "+gADAAYAAwADAAMABAADAAMAAwDNAQ==",
    np.dtype('<i2'), (11,))
SILK_NLSF_NB_MB_EC_ICDF = _t(
    "//797g4DAgEA//782iMDAgEA//760DsEAgEA//72wkcKAgEA//zst1IIAgEA"
    "//zrtFoRAgEA//jgq2EeBAEA//7srV8lBwEA",
    np.dtype('|u1'), (8, 9))
SILK_NLSF_NB_MB_EC_RATES_Q5 = _t(
    "////gwaR///////sXQ9g///////CUxlH3f////+iSSJCov///9J+SSs5rf//"
    "/8l9RzA6gv///6ZuSTk+aNL///t7QTdEZKv/",
    np.dtype('|u1'), (8, 9))
SILK_NLSF_NB_MB_EC_SEL = _t(
    "EAAAAABjQiQkIiQiIiIiU0UkNCJ0ZkZERLBmREQiQVVEVCR0jZiLqoS7uNiJ"
    "hPmouYtoZmRERLLaubmq9Ni7u6r0u7vbimebuLmJdLebmIiE2bi4qqTZq5uL"
    "9Km4uaqk2N/aitaPvNqo9I2Im6qoitzbi6TbytiJqLr2uYt0udu5imRkhmRm"
    "IkREZESoy93aqKeaiGhGpPariYuJm9rbiw==",
    np.dtype('|u1'), (32, 5))
SILK_NLSF_NB_MB_INVQSTEP_Q6 = _t(
    "ZAE=",
    np.dtype('<i2'), (1,))
SILK_NLSF_NB_MB_PRED_Q8 = _t(
    "s4qMlJeVmZejdENSO1xIZFlc",
    np.dtype('|u1'), (18,))
SILK_NLSF_NB_MB_QSTEP_Q16 = _t(
    "FC4=",
    np.dtype('<i2'), (1,))
SILK_NLSF_ORDERING10 = _t(
    "AAkGAwQFCAECBw==",
    np.dtype('|u1'), (10,))
SILK_NLSF_ORDERING16 = _t(
    "AA8IBwQLDAMCDQoFBgkOAQ==",
    np.dtype('|u1'), (16,))
SILK_NLSF_WB_CB1_ICDF = _t(
    "4czJuLevnpqZh3dzcW5tY2JfT0Q0MjAtKyAfGxIKAwD/++vm1MnEtqemo5eK"
    "fG5oWk5MRkU5LSIYFQsGBQQDAA==",
    np.dtype('|u1'), (2, 32))
SILK_NLSF_WB_CB1_Q8 = _t(
    "BxcmNkVVZHSDk6KywdDf7w0ZKTdFU2Jwf46dq7vL3OwPFSIzPU5can6ImKe5"
    "zeHwChUkMj9PX25+jZ2tvc3d7REUJTM7Tllre4aWpLjN4PAKDyAzQ1FgcIGO"
    "nq29zNzsCBUlM0FPYnF+ipuos8DR2gwPIjc/TldsdoOUp7nL2+wQEyAkOE9b"
    "bHaImqu6zNztCxwrOkpZaXiHlqW0xNPi8QYQIS48S1xre4mcqbnH1uELEx4s"
    "OUpZaXmHmKm6ytrqDBMdLjlHWGR4hJSltsfY6REXIy44TVxqe4aYp7nM3u0O"
    "ES01P0tZa3OEl6u8zt3wCRAdKDhHWGd3iZqrvc3e7RATJDA5TFdpdoSWp7nK"
    "2uwMER02R1FeaH6IlaS2yd3tDxwvPk9hc4GOm6i0wtDf7ggOHi0+Tl5vf4+f"
    "r8DP3+8RHjE+T1xrd4SRoK6+zNzrDhMkLT1MW2x5ipqsvc3e7gwSHy08TFtr"
    "e4qaq7vM3ewNER8rNUZTZ3KDlae5y9ztERYjKjpOXW59i5uqvM7g8AgPIjJD"
    "U2Nzg5KissHR4O8NEClCSVZfb4CJlqO3zuHxERklND9LXGZ3hJCgr7/U5xMf"
    "MUFTZHWFk6Guu8jV4/ISHzREWGd1foqVo7HAz9/vEB0vPUxaaneFk6GwwdHg"
    "8A8VIzI9SVZhbneBja/G2u0=",
    np.dtype('|u1'), (32, 16))
SILK_NLSF_WB_CB1_WGHT_Q9 = _t(
    "SQ5tC20LbQttC20LbQttC20LbQttC20LkwuTC20LHguQDA0MnAvwC/ALwgvC"
    "C8ILkwuTC8ILnAtICx4LHgumClAPrg+lC4cMhwx2C/ALHgsyDKwMbQseCzwK"
    "+QncCm0LvA19DMILHwzLC0gLbQttC20LbQtIC0gLSAtIC0gLwQq+E74Tdgv1"
    "DTkN8AsNDOkKWAxYDJwLHgvRCewJwQpIC0wRNRCMCsEKnAvCC20LHgulC8sL"
    "bQttC20LbQtIC6YKJA7LC5wL8AvwCzkL9grwC5AM5wulC9sM2wylC+4Mrwtr"
    "FJYT7AkKDcYNOQ19DBYMMA2lC4wKVwp/CukKHgtxCtkTNhQHEkwRnAlRC+cL"
    "hwxhDH8KtApICx4L6QoeC4wKMgxIC5MLbQttC20LbQuTC5MLkwuTC20LbQuT"
    "C5MLkwtqEIcMpQsfDMILSAtIC20LnAs5C2QLywucC8ILfQw5C7AOsA6sDB8M"
    "pQtIC20LSAucC3YL6QrpCh4LSAtIC2QKDg+uD4cMMgysDHYL5wuTC5MLDQwe"
    "C+kK6QrpCukKFAoFD/APHQ28DRYMtArCC3YLMgwNDB4LHgtXClcKHgv2ChsU"
    "HhOZDAUPcQ1hDFELVQ17DYwKFApxCrQKHgv2CsEKDRDNDtsMWAxtC0gLSAtt"
    "C+kKtArpCrQK6QoeC0gL9grZE74T5wvZDawM8AsNDIALHwxRC7QKtAq0Ch4L"
    "6Qo8CtUQ1RAsC98JhwwwDTANAwwDDDAN8AseC1cKFAqmCsEK8AtkC/YKSAu0"
    "Cn8KUQsfDE4MTgyQDGEM8AvCC5MLHgsXESoPbQtICx4LSAseCx4LSAtIC0gL"
    "HgtIC20LSAseC6ULZAtkC6ULpQvwCzIMkAxODPALwgucC5wLnAttC7QKhRA1"
    "EO4MEw1tC5MLSAulC6ULHgvpCrQKHgseCx4L6QrwD64PHwzCC20LbQttC0gL"
    "bQttCx4LHgseC+kKSAvcCgcS3xFhDHENhwylC1EL3gsyDLQKfwp/Cn8KtArp"
    "CowKNRCtEM0OSQ6mCtwKSAtIC8ILnAttCx4Lfwp/CukKSAt3EOINwQoeCx4L"
    "SAtIC0gLbQttC0gLbQttC20LkwtICzYUORPVCGgNzQ6XDRMNHgvuDJcNTgxR"
    "C5wJtwnBCm0Lew1lDjIMfQwdDecLhwyHDKULkAwNDG0LbQt/CuwJggmlC8IL"
    "6QrpCrQK6QoeC5wL8AsfDE4MTgxODB8MwgvCC4ALOQt/CqYK3ArCC2gN2Q0d"
    "DawM8AvCC5MLbQtICx4LywuAC1ELwgvCC5wLywsfDPAL8AvCC0gLHgttC20L"
    "SAtQD38Pwgt9DB0NkAzbDNsMlw14DnENpgqFCJwJFAovCg==",
    np.dtype('<i2'), (32, 16))
SILK_NLSF_WB_DELTA_MIN_Q15 = _t(
    "ZAADACgAAwADAAMABQAOAA4ACgALAAMACAAJAAcAAwBbAQ==",
    np.dtype('<i2'), (17,))
SILK_NLSF_WB_EC_ICDF = _t(
    "//799AwDAgEA//784CYDAgEA//770TkEAgEA//70w0UEAgEA//vouFQHAgEA"
    "//7wulYOAgEA//7vslseBQEA//jjsWQTAgEA",
    np.dtype('|u1'), (8, 9))
SILK_NLSF_WB_EC_RATES_Q5 = _t(
    "////nASa///////jZg9c///////VUxhI7P////+WTCE/1v///755TSs3uf//"
    "//WJRys7i/////+DQjJCa8L//6Z0TDc1ff//",
    np.dtype('|u1'), (8, 9))
SILK_NLSF_WB_EC_SEL = _t(
    "AAAAAAAAAAFkZmZERCQiYKRrnrm0uYtmQEIkIiIAASDQi42/mLmbaGCraKZm"
    "ZmaEAQAAAAAQEABQbU5ruYtnZdDUjYutmXtnJAAAAAAAAAEwAAAAAAAAIESH"
    "e3d3Z0ViRGd4dnZmR2KGiJ24tpmLhtCo+Eu9j3lrIDEiIiIAEQLS64t7uYlp"
    "hmKHaLZkt6uGZEZERkJCIoNApmZEJAIBAIamZkQiIkKE1Paei2trV2Zk2316"
    "iXZnhHKHiWmrajIipNaNj7mXeWfAIgAAAAAAAdBtSruG+Z+JZm6adldld2UA"
    "AgAkJEJEI2CkZmQkAAIhp4quZmRUAgJka3h3JMUYAA==",
    np.dtype('|u1'), (32, 8))
SILK_NLSF_WB_INVQSTEP_Q6 = _t(
    "qwE=",
    np.dtype('<i2'), (1,))
SILK_NLSF_WB_PRED_Q8 = _t(
    "r5SgsLKtrqSxrsS2xsC2RD5CPEh1VVp2iJeOoI6b",
    np.dtype('|u1'), (30,))
SILK_NLSF_WB_QSTEP_Q16 = _t(
    "ZiY=",
    np.dtype('<i2'), (1,))
SILK_PITCH_CONTOUR_10MS_ICDF = _t(
    "pXdQPS8jGxQOCQQA",
    np.dtype('|u1'), (12,))
SILK_PITCH_CONTOUR_10MS_NB_ICDF = _t(
    "cT8A",
    np.dtype('|u1'), (3,))
SILK_PITCH_CONTOUR_ICDF = _t(
    "38m3p5iKfG9iWE9GPjgyLCcjHxsYFRIQDgwKCAYEAwIBAA==",
    np.dtype('|u1'), (34,))
SILK_PITCH_CONTOUR_NB_ICDF = _t(
    "vLCbindhQysaCgA=",
    np.dtype('|u1'), (11,))
SILK_PITCH_DELTA_ICDF = _t(
    "0tDOy8fBt6iOaEo0JRsUDgoGBAIA",
    np.dtype('|u1'), (21,))
SILK_PITCH_LAG_ICDF = _t(
    "/fr06dS2loN4bmJVSDwxKCAZEw8NCwkIBwYFBAMCAQA=",
    np.dtype('|u1'), (32,))
SILK_PULSES_PER_BLOCK_ICDF = _t(
    "fTMaEg8MCwoJCAcGBQQDAgEAxmktFg8MCwoJCAcGBQQDAgEA1aJ0UzsrIBgS"
    "DwwJBwYFAwIA77t0OxwQCwoJCAcGBQQDAgEA+uW8h1YzHhMNCggGBQQDAgEA"
    "+evVuZyAZ1NCNSohGhURDQoA/vnrzqR2TS4bEAoHBQQDAgEA//3579y/nHdV"
    "OSUXDwoGBAIA//379u3fy7OYfGJLNygdFQ8A//7999yiakMqHBIMCQYEAwIA",
    np.dtype('|u1'), (10, 18))
SILK_QUANT_OFFSETS_Q10 = _t(
    "ZADwACAAZAA=",
    np.dtype('<i2'), (2, 2))
SILK_RATE_LEVELS_ICDF = _t(
    "8b6yhFdKKQ4A38GdjGo5JxIA",
    np.dtype('|u1'), (2, 9))
SILK_RESAMPLER_FRAC_FIR_12 = _t(
    "vQCo/WkCZ3d1AGH/0vsIdDQA3QCo9nRu/P8RAury5WbQ//YCjPClXbD/iQN1"
    "7wZTnf/MA4LvZkeV/8cDi/AnO5n/gANh8q4upf8FA8/0XiK5/2MCofeYFtL/"
    "qQGh+rQL",
    np.dtype('<i2'), (12, 4))
SILK_SHELL_CODE_TABLE0 = _t(
    "ggDIOgDnghoA9LhMDAD51oIrBgD86K1XGAMA/fHLgzgOAgD+9t2nXiMIAQD+"
    "+ejBgkEXBQEA//vv06JjLQ8EAQD/+/PfuoNKIQsDAQD//PXmyp5pORgIAgEA"
    "//3369azhFQsEwcCAQD//vrw38SfcEUkDwYCAQD//v3159GwiF03GwsDAgEA"
    "//79/O/dwp51TCoSBAMCAQA=",
    np.dtype('|u1'), (152,))
SILK_SHELL_CODE_TABLE1 = _t(
    "gQDLNgDqgRcA9bhJCgD614EpBQD86K1WGAMA/fDIgTgPAgD99NmkXiYKAQD9"
    "9eK9hEcbBwEA/fbny59pOBcGAQD/+OvVs4VVLxMFAQD//vPdwp91RiUMAgEA"
    "//746tCrgFUwFggCAQD//vrw3L2Va0MkEAYCAQD//vvz48mmgFo3HQ0FAgEA"
    "//789urVt5NtSSsWCgQCAQA=",
    np.dtype('|u1'), (152,))
SILK_SHELL_CODE_TABLE2 = _t(
    "gQDPMgDsgRQA9blICgD51YEqBgD64qlXGwQA++nCgj4UBAD67M+gYy8RAwD/"
    "8Nm2g1EpCwEA//7pyZ9rPRQCAQD/+enOqoBWMhcHAQD/+u7ZupRsRicSBgEA"
    "//zz4simgFo4Hg0EAQD//PXn0bSSbkwvGQsEAQD//fjt28KjgF0+JRMIAwEA"
    "//768eLNsZFvTzMeDwYCAQA=",
    np.dtype('|u1'), (152,))
SILK_SHELL_CODE_TABLE3 = _t(
    "gADWKgDrgBUA9LhICwD41oAqBwD44apQGQUA++zGfjYSAwD67tOfUiMPBQD6"
    "58uogFg1GQYA/O7YuZRsRygSBAD98+HHpoBaOR8NAwD+9unUt5NtSSwXCgIA"
    "//rw38amgFo6IRAGAQD/+/Tn0rWSbksuGQwFAQD//fju3cSkgFw8IxIIAwEA"
    "//358uXQtJJuTDAbDgcDAQA=",
    np.dtype('|u1'), (152,))
SILK_SIGN_ICDF = _t(
    "/jFDTVJdY8YLEhgfJC3/LkJOV15o0A4VICozQv9eaG1wc3b4NUVQWF9m",
    np.dtype('|u1'), (42,))
SILK_STEREO_ONLY_MID_ICDF = _t(
    "QAA=",
    np.dtype('|u1'), (2,))
SILK_STEREO_PRED_JOINT_ICDF = _t(
    "+ff29fTq0srJyMWuUjs4NzYuFgwLCgkHAA==",
    np.dtype('|u1'), (25,))
SILK_STEREO_PRED_QUANT_Q13 = _t(
    "XMq+2LbfmuKc5njsevTM/DQDhguIE2QZZh1KIEInpDU=",
    np.dtype('<i2'), (16,))
SILK_TYPE_OFFSET_NO_VAD_ICDF = _t(
    "5gA=",
    np.dtype('|u1'), (2,))
SILK_TYPE_OFFSET_VAD_ICDF = _t(
    "6J4KAA==",
    np.dtype('|u1'), (4,))
SILK_UNIFORM3_ICDF = _t(
    "q1UA",
    np.dtype('|u1'), (3,))
SILK_UNIFORM4_ICDF = _t(
    "wIBAAA==",
    np.dtype('|u1'), (4,))
SILK_UNIFORM5_ICDF = _t(
    "zZpmMwA=",
    np.dtype('|u1'), (5,))
SILK_UNIFORM6_ICDF = _t(
    "1auAVSsA",
    np.dtype('|u1'), (6,))
SILK_UNIFORM8_ICDF = _t(
    "4MCggGBAIAA=",
    np.dtype('|u1'), (8,))
SILK_UP2_HQ_0 = _t(
    "0gYAAIo6AACrmP//",
    np.dtype('<i4'), (3,))
SILK_UP2_HQ_1 = _t(
    "xhoAAKlkAAD22P//",
    np.dtype('<i4'), (3,))
