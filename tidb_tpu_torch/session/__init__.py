from .catalog import Catalog, TableInfo, CatalogError, type_from_sql
from .session import Session, Domain, ResultSet
