from . import ast
from .lexer import tokenize, Token, LexError
from .parser import Parser, ParseError, parse_sql, parse_one

__all__ = ["ast", "tokenize", "Token", "LexError", "Parser", "ParseError",
           "parse_sql", "parse_one"]
