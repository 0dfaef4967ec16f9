from .book import OracleEngine, SymbolBook, RestingOrder

__all__ = ["OracleEngine", "SymbolBook", "RestingOrder"]
