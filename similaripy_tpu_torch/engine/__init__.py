from .splus import s_plus
